"""Space-to-depth packing and depth-to-space unpacking, NCHW.

Counterpart of ``mindtheedge_tpu/ops/packing.py``.  The channel order is the
reference PackNet's: input (c, i, j), with (i, j) the offset inside each
r x r cell, lands on output channel c*r^2 + i*r + j.  That is exactly
``pixel_unshuffle`` / ``pixel_shuffle``.
"""

import torch.nn.functional as F


def pack2d(x, r=2):
    """[B,C,H,W] -> [B,C*r^2,H/r,W/r]."""
    return F.pixel_unshuffle(x, r)


def unpack2d(x, r=2):
    """[B,C*r^2,H,W] -> [B,C,H*r,W*r]."""
    return F.pixel_shuffle(x, r)


def upsample_nearest2x(x):
    """Nearest-neighbour 2x upsample of [B,C,H,W]."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
