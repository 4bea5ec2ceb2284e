"""Inverse depth <-> depth (counterpart of ``mindtheedge_tpu/utils/depth.py:14-26``)."""

import torch


def inv2depth(inv_depth):
    """1 / clamp(inv, min=1e-6) (reference ``utils/depth.py:104-121``)."""
    if isinstance(inv_depth, (list, tuple)):
        return [inv2depth(d) for d in inv_depth]
    return 1.0 / torch.clamp(inv_depth, min=1e-6)


def depth2inv(depth):
    """1/depth with invalid (<= 0) pixels set to 0 (``utils/depth.py:124-144``)."""
    if isinstance(depth, (list, tuple)):
        return [depth2inv(d) for d in depth]
    inv = 1.0 / torch.clamp(depth, min=1e-6)
    return torch.where(depth <= 0.0, 0.0, inv)
