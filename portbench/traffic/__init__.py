"""The one traffic generator: seeded synthetic driving scenes made on the card.

A traffic mix (``portbench/workloads/<traffic>.json``) sets its
parameters; nothing here is specific to one mix.  A scene is a far plane
with axis-aligned boxes nearer the camera (``scene`` parameters: ``far_m``,
``near_m`` [lo, hi], ``boxes``), the RGB shading its depth plus uniform
noise (``noise``), the LiDAR its depth at a uniform ``density`` of the
pixels (0 = no point), on the 1/256 m grid of KITTI's uint16 PNGs.  The
box layout is drawn from a CPU generator and every pixel from a
generator on the device, both seeded from ``--seed``: the same seed gives
the same pool; every seed gives the same sizes.

Pools (lists of ready requests or batches, which the loop rotates through):

* ``serve_pool``: uint8 RGB and float32 LiDAR in pinned host memory;
* ``train_pool``: training batches on the card, NHWC: RGB, LiDAR, sparse
  GT depth at ``gt_density``, and at 4 scales the depth edges (a step to
  the right or below) and the Sobel-5 normals decoded to radians.
"""

import math

import torch

from portbench.reference.edges import normal_codes

STREAMS = {'weights': 1, 'boxes': 2, 'pixels': 3, 'draws': 4, 'sample': 5}


def stream_seed(seed, stream):
    """A seed of its own for each use of ``--seed`` (weights, the box
    layout, the pixels, the training draws, the check's sample)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream]) % (2 ** 63)


def scenes(n, h, w, scene, seed, device):
    """[n,h,w] depth in metres: ``far_m`` with ``boxes`` boxes per image at
    depths uniform in ``near_m``."""
    gen = torch.Generator().manual_seed(stream_seed(seed, 'boxes'))
    boxes = scene['boxes']
    u = torch.rand(n, boxes, 5, generator=gen, dtype=torch.float64)
    lo, hi = scene['near_m']
    depth = torch.full((n, h, w), float(scene['far_m']), device=device)
    for i in range(n):
        for y, x, bh, bw, d in u[i].tolist():
            hh = h // 16 + int(bh * (h // 3 - h // 16))
            ww = w // 16 + int(bw * (w // 3 - w // 16))
            y0, x0 = int(y * (h - h // 8)), int(x * (w - w // 8))
            depth[i, y0:y0 + hh, x0:x0 + ww] = lo + d * (hi - lo)
    return depth


def _pixels(seed, device):
    return torch.Generator(device=device).manual_seed(stream_seed(seed, 'pixels'))


def _shade(depth, scene, gen):
    noise = torch.rand(*depth.shape, 3, device=depth.device, generator=gen)
    return torch.clamp((depth / scene['far_m'])[..., None] + scene['noise'] * noise, 0.0, 1.0)


def _sample(depth, density, gen):
    keep = torch.rand(depth.shape, device=depth.device, generator=gen) < density
    return torch.where(keep, torch.round(depth * 256.0) / 256.0, 0.0)[..., None]


def _pinned(t):
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    out.copy_(t)
    return out


def _chunks(t, n, b):
    return [t[i * b:(i + 1) * b] for i in range(n)]


def serve_pool(traffic, h, w, seed, device):
    """[(rgb uint8 [B,H,W,3], lidar float32 [B,H,W,1])] * pool, pinned."""
    n, b = traffic['pool'], traffic['batch']
    gen = _pixels(seed, device)
    depth = scenes(n * b, h, w, traffic['scene'], seed, device)
    rgb = torch.round(_shade(depth, traffic['scene'], gen) * 255.0).to(torch.uint8)
    lidar = _sample(depth, traffic['lidar']['density'], gen)
    return list(zip(_chunks(_pinned(rgb), n, b), _chunks(_pinned(lidar), n, b)))


def decode_normal(code):
    """A normal code in [0, 255] -> its angle in radians, as the training
    split's normal PNGs are read."""
    return (code / 255.0) * 2 * math.pi - math.pi


def train_pool(traffic, h, w, seed, device):
    """[batch dict] * pool, on the card."""
    n, b = traffic['pool'], traffic['batch']
    gen = _pixels(seed, device)
    depth = scenes(n * b, h, w, traffic['scene'], seed, device)
    rgb = _shade(depth, traffic['scene'], gen)
    lidar = _sample(depth, traffic['lidar']['density'], gen)
    gt = _sample(depth, traffic['gt_density'], gen)
    pool = []
    for i in range(n):
        d = depth[i * b:(i + 1) * b]
        batch = {'rgb': rgb[i * b:(i + 1) * b].contiguous(),
                 'input_depth': lidar[i * b:(i + 1) * b].contiguous(),
                 'depth': gt[i * b:(i + 1) * b].contiguous()}
        for s, key in enumerate(('', '_1', '_2', '_3')):
            ds = d[:, ::2 ** s, ::2 ** s].contiguous()
            edge = torch.zeros_like(ds, dtype=torch.bool)
            edge[:, :, :-1] |= ds[:, :, 1:] != ds[:, :, :-1]
            edge[:, :-1] |= ds[:, 1:] != ds[:, :-1]
            batch['edge' + key] = edge.float()[..., None]
            batch['normal' + key] = decode_normal(normal_codes(ds))[..., None]
        pool.append(batch)
    return pool
