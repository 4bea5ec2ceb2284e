"""The serving forward: PackNet-SAN depth plus depth edges.

Counterpart of ``__graft_entry__.entry()`` and ``bench.py``'s
``_depth_edges`` / ``make_serving``:

* ``build`` makes the PackNet-SAN 1A model (random weights from a seed) in
  eval mode on the device, in fp32 or, as ``bench.py`` serves it, with its
  weights cast once to bf16; on the card it first builds the path's CUDA
  kernels (the 3-D conv and the NMS), their nvcc processes at once;
* ``depth_edges`` runs the forward, casts ``inv_depth`` to fp32, and runs
  ``inv2depth`` and the fused Sobel-5 + NMS kernel (f32) on
  ``clip(inv_depth / 2, 0, 1)``;
* ``serve`` takes uint8 RGB, normalises it on the device (``u8 / 255`` in
  fp32, then cast to the model's dtype, as the LiDAR is) and returns the
  wire encodings: uint16 (or uint8) depth and bit-packed edges.

Inputs and outputs are NHWC / [B,H,W], as in the JAX package.
"""

import torch

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.models.packnet import (
    SLIM_CHANNELS, PackNetSAN, init_weights, to_device)
from mindtheedge_tpu_torch.ops.wire import (
    encode_depth_u8, encode_depth_u16, pack_edges)
from mindtheedge_tpu_torch.ops.cuda import build as kernels
from mindtheedge_tpu_torch.ops.cuda.nms_kernel import non_max_suppression
from mindtheedge_tpu_torch.utils.depth import inv2depth
from mindtheedge_tpu_torch.utils.profiling import count, span

_DEPTH_ENCODERS = {'u16': encode_depth_u16, 'u8': encode_depth_u8}


def build(channels=SLIM_CHANNELS, device=None, seed=0, dtype=torch.float32):
    """PackNet-SAN 1A with weights drawn from ``seed`` (in fp32, then cast
    to ``dtype``), in eval mode on ``device`` (``None`` -> CUDA, which must
    be present), through ``models.packnet.to_device``."""
    device = resolve_device(device)
    if device.type == 'cuda':
        kernels.build(*kernels.KERNELS)
    return to_device(init_weights(PackNetSAN(tuple(channels)), seed), device, dtype)


def _inv_depth(model, rgb, lidar):
    return model(rgb, lidar)['inv_depths'][0][..., 0].float()


def _maps(inv_depth):
    prob = torch.clamp(inv_depth / 2.0, 0.0, 1.0)
    return {'depth': inv2depth(inv_depth), 'edges': non_max_suppression(prob)}


@torch.no_grad()
def depth_edges(model, rgb, lidar):
    """rgb [B,H,W,3] float in [0,1], lidar [B,H,W,1] metres (0 = no point),
    in the model's dtype -> {'depth': [B,H,W], 'edges': [B,H,W]}, fp32."""
    inv_depth = _inv_depth(model, rgb, lidar)
    with span('mte.serve.post'):
        return _maps(inv_depth)


def _upload(t, device, dtype=None):
    """``t`` on ``device`` (in ``dtype``), counting the bytes copied from the
    host (a host tensor is cast before its copy)."""
    count('h2d_bytes', 0 if t.device == device else t.numel() * (dtype or t.dtype).itemsize)
    return t.to(device, dtype)


@torch.no_grad()
def serve(model, rgb_u8, lidar, wire='u16'):
    """One request: uint8 rgb [B,H,W,3] and lidar [B,H,W,1], on any device
    -> (depth on the wire, edges bit-packed [B,H,W/8]) on the model's device:
    the steps of :func:`depth_edges` on the uploaded inputs, then the wire
    encodes; spans ``mte.serve.request``, ``mte.serve.input`` (with the
    counter ``h2d_bytes``) and ``mte.serve.post`` (``utils/profiling.py``)."""
    encode = _DEPTH_ENCODERS[wire]
    weight = next(model.parameters())
    with span('mte.serve.request'):
        with span('mte.serve.input'):
            rgb = (_upload(rgb_u8, weight.device).to(torch.float32) / 255.0).to(weight.dtype)
            lidar = _upload(lidar, weight.device, weight.dtype)
        inv_depth = _inv_depth(model, rgb, lidar)
        with span('mte.serve.post'):
            out = _maps(inv_depth)
            return encode(out['depth']), pack_edges(out['edges'] > 0.5)
