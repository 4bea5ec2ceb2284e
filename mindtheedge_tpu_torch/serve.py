"""The serving forward: PackNet-SAN depth plus depth edges.

Counterpart of ``__graft_entry__.entry()`` and ``bench.py``'s
``_depth_edges`` / ``make_serving``:

* ``build`` makes the PackNet-SAN 1A model (random weights from a seed) in
  eval mode on the device;
* ``depth_edges`` runs the forward, ``inv2depth`` and the fused Sobel-5 +
  NMS kernel on ``clip(inv_depth / 2, 0, 1)``;
* ``serve`` takes uint8 RGB, normalises it on the device and returns the
  wire encodings: uint16 (or uint8) depth and bit-packed edges.

Inputs and outputs are NHWC / [B,H,W], as in the JAX package.
"""

import torch

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.models.packnet import (
    SLIM_CHANNELS, PackNetSAN, init_weights, to_device)
from mindtheedge_tpu_torch.ops.wire import (
    encode_depth_u8, encode_depth_u16, pack_edges)
from mindtheedge_tpu_torch.ops.cuda.nms_kernel import non_max_suppression
from mindtheedge_tpu_torch.utils.depth import inv2depth

_DEPTH_ENCODERS = {'u16': encode_depth_u16, 'u8': encode_depth_u8}


def build(channels=SLIM_CHANNELS, device=None, seed=0):
    """PackNet-SAN 1A with weights drawn from ``seed``, in eval mode on
    ``device`` (``None`` -> CUDA, which must be present), through
    ``models.packnet.to_device``."""
    device = resolve_device(device)
    return to_device(init_weights(PackNetSAN(tuple(channels)), seed), device)


@torch.no_grad()
def depth_edges(model, rgb, lidar):
    """rgb [B,H,W,3] float in [0,1], lidar [B,H,W,1] metres (0 = no point)
    -> {'depth': [B,H,W], 'edges': [B,H,W]}."""
    inv_depth = model(rgb, lidar)['inv_depths'][0][..., 0].float()
    prob = torch.clamp(inv_depth / 2.0, 0.0, 1.0)
    return {'depth': inv2depth(inv_depth), 'edges': non_max_suppression(prob)}


@torch.no_grad()
def serve(model, rgb_u8, lidar, wire='u16'):
    """One request: uint8 rgb [B,H,W,3] and lidar [B,H,W,1], on any device
    -> (depth on the wire, edges bit-packed [B,H,W/8]) on the model's device."""
    encode = _DEPTH_ENCODERS[wire]
    device = next(model.parameters()).device
    rgb = rgb_u8.to(device).to(torch.float32) / 255.0
    out = depth_edges(model, rgb, lidar.to(device))
    return encode(out['depth']), pack_edges(out['edges'] > 0.5)
