"""Serving wire codecs: counterpart of ``mindtheedge_tpu/ops/wire.py``.

* edges: binary map bit-packed along the last axis, 1 bit per pixel, in
  ``np.packbits`` order (first pixel in the most significant bit);
* depth: uint16 at 1/256 m (the KITTI depth-png format), or the edge-AUC
  protocol's uint8 grid of 80/255 m;
* LiDAR up: sparse (flat index, uint16 depth at 1/256 m) point lists padded
  to a fixed capacity, encoded on the host with numpy and scattered to the
  dense map on the device.

The depth and edge encoders run on the tensor's device; every decoder
returns the exact values the encoder quantised to.
"""

import numpy as np
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


def encode_lidar_sparse(dense, capacity):
    """Host, numpy (``wire.py:67-86``): dense [H,W] or [H,W,1] float depth ->
    (idx uint32 [capacity], val uint16 [capacity]).  Valid points are
    d > 0, in row-major order; padding slots carry idx = H*W.  Raises
    ValueError if the frame has more valid points than ``capacity``."""
    d = np.asarray(dense)
    if d.ndim == 3:
        d = d[..., 0]
    h, w = d.shape
    flat = d.reshape(-1)
    nz = np.flatnonzero(flat > 0)
    if len(nz) > capacity:
        raise ValueError(
            f'{len(nz)} lidar points exceed wire capacity {capacity}; '
            'raise capacity (points are ~5% of pixels for KITTI lidar)')
    idx = np.full((capacity,), h * w, dtype=np.uint32)
    val = np.zeros((capacity,), dtype=np.uint16)
    idx[:len(nz)] = nz
    val[:len(nz)] = np.clip(np.round(flat[nz] * DEPTH_SCALE), 0, 65535)
    return idx, val


def decode_lidar_sparse(idx, val, height, width):
    """On the tensors' device (``wire.py:89-103``): ([B,]capacity integer
    indices, [B,]capacity uint16 values) -> dense [B,H,W,1] float32 metres.
    Indices outside [0, H*W) (the padding is H*W) are dropped, not clamped
    into the image: they scatter into one spare column past the image,
    which is cut off."""
    if idx.ndim == 1:
        idx, val = idx[None], val[None]
    hw = height * width
    idx = idx.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < hw), idx, hw)
    dense = torch.zeros(idx.shape[0], hw + 1, dtype=torch.float32,
                        device=idx.device)
    dense.scatter_(1, idx, val.to(torch.float32) / DEPTH_SCALE)
    return dense[:, :hw].reshape(idx.shape[0], height, width, 1)
