"""Self-supervised training batches: a target frame and its two context
frames under a known ego-motion, made on the card from the seed.

A mix (``portbench/workloads/<traffic>.json``) sets ``pool`` batches of
``batch`` frames.  Each target's depth is a scene of
:func:`portbench.traffic.scenes` (``scene``: ``far_m``, ``near_m``,
``boxes``); its RGB shades the depth, ``(1 - noise) * depth / far_m``,
plus ``noise`` times a texture on the image plane: uniform noise on a
``texture_px`` grid, bicubically upsampled and clamped to [0, 1]
(smooth, as natural images are between their edges: on white noise the
bilinear sampler's derivative jumps by O(1) at every integer coordinate).
The texture covers the far plane too, so no part of a frame is flat.

Each context frame (``contexts``: ``forward_m`` along the optical axis and
``yaw_deg`` about the vertical axis, the context camera's place in the
target's frame) is the target warped by the plain reference's view
synthesis through the target's depth moved by ``-forward_m`` (a
fronto-parallel surface's depth as the context camera sees it) under the
context-to-target pose, border-padded.  The true target-to-context pose
is its inverse.  ``intrinsics`` gives ``fx``, ``fy``, ``cx``, ``cy`` at
``width`` x ``height``, scaled to the frame as KITTI's loader scales them.

A batch is NHWC on the card, as the program's dataset gives it: ``rgb``
and ``rgb_original`` (the same frame: no colour jitter), ``rgb_context``
and ``rgb_context_original`` (the same list), ``intrinsics`` [B,3,3].
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference import selfsup as ref
from portbench.reference.packnet import nhwc
from portbench.traffic import scenes, stream_seed


def intrinsics(spec, h, w, n, device):
    """[n,3,3] pinhole intrinsics of ``spec`` scaled to ``h`` x ``w``."""
    sx, sy = w / spec['width'], h / spec['height']
    K = torch.tensor([[spec['fx'] * sx, 0.0, spec['cx'] * sx],
                      [0.0, spec['fy'] * sy, spec['cy'] * sy],
                      [0.0, 0.0, 1.0]], device=device)
    return K.expand(n, 3, 3).contiguous()


def context_to_target(motion, n, device):
    """[n,3,4]: a point in the context camera's frame -> the target's."""
    yaw = math.radians(motion['yaw_deg'])
    angle = torch.tensor([[0.0, yaw, 0.0]], device=device).expand(n, 3)
    t = torch.tensor([0.0, 0.0, motion['forward_m']], device=device).expand(n, 3)
    return torch.cat([ref.euler2mat(angle), t[..., None]], 2)


def selfsup_pool(traffic, h, w, seed, device):
    """[batch dict] * ``pool``, on the card."""
    n, b = traffic['pool'], traffic['batch']
    scene = traffic['scene']
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 'pixels'))
    depth = scenes(n * b, h, w, scene, seed, device)[:, None]
    px = traffic['texture_px']
    grid = torch.rand(n * b, 3, h // px + 2, w // px + 2, device=device, generator=gen)
    texture = F.interpolate(grid, size=(h, w), mode='bicubic', align_corners=True).clamp(0, 1)
    rgb = (1 - scene['noise']) * depth / scene['far_m'] + scene['noise'] * texture
    K = intrinsics(traffic['intrinsics'], h, w, n * b, device)
    contexts = [ref.view_synthesis(rgb, (depth - m['forward_m']).clamp(min=1.0), K, K,
                                   context_to_target(m, n * b, device), padding_mode='border')
                for m in traffic['contexts']]
    pool = []
    for i in range(n):
        rows = slice(i * b, (i + 1) * b)
        target = nhwc(rgb[rows]).contiguous()
        ctx = [nhwc(c[rows]).contiguous() for c in contexts]
        pool.append({'rgb': target, 'rgb_original': target, 'rgb_context': ctx,
                     'rgb_context_original': ctx, 'intrinsics': K[rows]})
    return pool
