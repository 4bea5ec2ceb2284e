"""Space-to-depth packing and depth-to-space unpacking of [B,C,H,W].

Counterpart of ``mindtheedge_tpu/ops/packing.py``.  The channel order is the
reference PackNet's: input (c, i, j), with (i, j) the offset inside each
r x r cell, lands on output channel c*r^2 + i*r + j.  That is exactly
``pixel_unshuffle`` / ``pixel_shuffle``.  Each moves pixels only within
an r x r cell, so a spatially sharded block packs alone where its local
extents divide by r.

Each keeps its input's layout: an NCHW tensor goes through
``pixel_unshuffle`` / ``pixel_shuffle``, a channels-last one (the bf16
networks' NHWC activations, ``ops/blocks.nhwc``) through the same shuffle
written on its NHWC view, since on the card ``pixel_(un)shuffle`` returns
NCHW.  Either way the shuffle is one copy of the tensor.
"""

import torch
import torch.nn.functional as F


def channels_last(x):
    """Whether [B,C,H,W] ``x`` is laid out NHWC (``torch.channels_last``) and
    not NCHW-contiguous."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def pack2d(x, r=2, space=None):
    """[B,C,H,W] -> [B,C*r^2,H/r,W/r], in ``x``'s layout.  Under ``space`` (a
    spatially sharded block) the local H and W must divide by ``r``."""
    if space is not None and (x.shape[-2] % r or x.shape[-1] % r):
        raise ValueError(f'spatial sharding: the local block {tuple(x.shape[-2:])} does '
                         f'not pack by {r}; legal grids keep (H / n) % 32 == 0 '
                         '(parallel/spatial.legal_space_sizes)')
    return pack2d_nhwc(x, r) if channels_last(x) else F.pixel_unshuffle(x, r)


def unpack2d(x, r=2):
    """[B,C*r^2,H,W] -> [B,C,H*r,W*r], in ``x``'s layout."""
    return unpack2d_nhwc(x, r) if channels_last(x) else F.pixel_shuffle(x, r)


def pack2d_nhwc(x, r=2):
    """``pixel_unshuffle`` of [B,C,H,W] computed on its NHWC view: the
    result is channels-last."""
    b, c, h, w = x.shape
    t = x.permute(0, 2, 3, 1).reshape(b, h // r, r, w // r, r, c)          # b, h', i, w', j, c
    return t.permute(0, 1, 3, 5, 2, 4).reshape(b, h // r, w // r, c * r * r).permute(0, 3, 1, 2)


def unpack2d_nhwc(x, r=2):
    """``pixel_shuffle`` of [B,C*r^2,H,W] computed on its NHWC view: the
    result is channels-last."""
    b, crr, h, w = x.shape
    c = crr // (r * r)
    t = x.permute(0, 2, 3, 1).reshape(b, h, w, c, r, r)                    # b, h, w, c, i, j
    return t.permute(0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, c).permute(0, 3, 1, 2)


def upsample_nearest2x(x):
    """Nearest-neighbour 2x upsample of [B,C,H,W]."""
    return F.interpolate(x, scale_factor=2, mode='nearest')
