"""Space-to-depth packing and depth-to-space unpacking, NCHW.

Counterpart of ``mindtheedge_tpu/ops/packing.py``.  The channel order is the
reference PackNet's: input (c, i, j), with (i, j) the offset inside each
r x r cell, lands on output channel c*r^2 + i*r + j.  That is exactly
``pixel_unshuffle`` / ``pixel_shuffle``.  Each moves pixels only within
an r x r cell, so a spatially sharded block packs alone where its local
extents divide by r.
"""

import torch.nn.functional as F


def pack2d(x, r=2, space=None):
    """[B,C,H,W] -> [B,C*r^2,H/r,W/r].  Under ``space`` (a spatially
    sharded block) the local H and W must divide by ``r``."""
    if space is not None and (x.shape[-2] % r or x.shape[-1] % r):
        raise ValueError(f'spatial sharding: the local block {tuple(x.shape[-2:])} does '
                         f'not pack by {r}; legal grids keep (H / n) % 32 == 0 '
                         '(parallel/spatial.legal_space_sizes)')
    return F.pixel_unshuffle(x, r)


def unpack2d(x, r=2):
    """[B,C*r^2,H,W] -> [B,C,H*r,W*r]."""
    return F.pixel_shuffle(x, r)


def upsample_nearest2x(x):
    """Nearest-neighbour 2x upsample of [B,C,H,W]."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
