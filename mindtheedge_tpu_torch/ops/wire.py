"""Serving wire codecs: counterpart of ``mindtheedge_tpu/ops/wire.py:34-61,
106-124``.

* edges: binary map bit-packed along the last axis, 1 bit per pixel, in
  ``np.packbits`` order (first pixel in the most significant bit);
* depth: uint16 at 1/256 m (the KITTI depth-png format), or the edge-AUC
  protocol's uint8 grid of 80/255 m.

Every encoder runs on the tensor's device; every decoder returns the exact
values the encoder quantised to.
"""

import torch

DEPTH_SCALE = 256.0     # KITTI depth-png convention
U8_MAX_DEPTH = 80.0     # edge-AUC protocol grid: clip(d, 0, 80) * 255 / 80

_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def _shifts(device):
    return torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=device)


def pack_edges(edges):
    """[..., W] binary (nonzero = edge) -> uint8 [..., W//8]; W % 8 == 0."""
    w = edges.shape[-1]
    if w % 8:
        raise ValueError(f'W={w} is not a multiple of 8')
    bits = (edges != 0).to(torch.uint8).reshape(*edges.shape[:-1], w // 8, 8)
    return (bits << _shifts(edges.device)).sum(-1, dtype=torch.uint8)


def unpack_edges(packed):
    """Inverse of :func:`pack_edges` -> uint8 {0,1} [..., W]."""
    bits = (packed.unsqueeze(-1) >> _shifts(packed.device)) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def encode_depth_u16(depth):
    """float depth [m] -> uint16 at 1/256 m, clipped to [0, 65535]."""
    d = torch.round(depth.float() * DEPTH_SCALE)
    return torch.clamp(d, 0.0, 65535.0).to(torch.uint16)


def decode_depth_u16(u16):
    """-> float32 metres."""
    return u16.to(torch.float32) / DEPTH_SCALE


def encode_depth_u8(depth):
    """float depth [m] -> uint8 on the 80/255 m grid (eval-only serving)."""
    d = torch.round(torch.clamp(depth.float(), 0.0, U8_MAX_DEPTH)
                    * (255.0 / U8_MAX_DEPTH))
    return d.to(torch.uint8)


def decode_depth_u8(u8):
    """-> float32 metres on the protocol grid."""
    return u8.to(torch.float32) * (U8_MAX_DEPTH / 255.0)
