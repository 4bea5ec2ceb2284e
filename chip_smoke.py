"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root, on a machine with one CUDA card and nvcc.

1. Build every CUDA kernel of the path from ``mindtheedge_tpu_torch/csrc``
   (nvcc, sm_90a) into ``build/kernels/``.
2. Hold the Sobel-5 + NMS kernel against its plain PyTorch version on the
   card: uniform noise [4,384,1280], Gaussian-smoothed noise x4, the DEE
   annotation scales, odd shapes (W % 4 != 0, H below one band), an input
   that is not 16-byte aligned and the exact-dyadic zero-gradient patch.
   >= 99.99 % of pixels agree, every pixel of the patch, and kept values
   are bit-equal.
3. Run a small PackNet-SAN 1A (channels (16,)*6, 64x96, batch 2, LiDAR) on
   the card and on the CPU with the same weights: all 4 scales at rtol 1e-4,
   atol 1e-5, TF32 off.
   Then ``annotate_batch`` of the DEE path, card vs CPU on the same
   network and inputs: edge maps within 1e-4 on >= 99.9 % of pixels per
   scale,
   normals within one code on >= 99.9 %, hysteresis bit-equal.
4. Serve full-width PackNet-SAN 1A (SLIM channels, 384x1280, batch 4, fp32,
   95 %-sparse LiDAR) built by ``serve.build``: 2 warm-up requests (the
   first one runs cuDNN's autotuner) and 5 timed ones through
   ``serve.serve``, rgb and LiDAR perturbed on every request; the NMS
   kernel must launch once per request.  Then time the kernel: at
   [4,384,1280] on 8 inputs in turn (more than L2) by CUDA events, and by
   ``torch.profiler`` over the same kind of run; on the served map, warm in
   L2 as on the main path; at the DEE scales; and its plain version.
5. The DEE annotation path at full width (``EdgeEstimationLIDARModel``, the
   same network, LiDAR /200): 2 warm-up and 5 timed batches through
   ``cli.infer_edge_estimation.annotate_batch`` (forward, then at each of
   the 4 scales normals, the NMS kernel and hysteresis), uploads and
   read-backs included; the NMS kernel must launch 4 times per batch.
   Each scale's NMS map is held against the plain version, and hysteresis
   on the card against hysteresis on the CPU, bit for bit.  Prints ms per
   batch, hysteresis iterations, checks and their cost per scale, host
   syncs per batch, peak memory, the kernel's time at the 4 shapes and
   the time of each stage alone.
6. The batch-inference path at full width (``SemiSupEdgeModel``, the same
   network): 2 warm-up and 5 timed batches through
   ``cli.infer_edges.infer_batch`` with the sparse uint16 LiDAR uplink and
   the uint16 depth downlink, uploaded and read back by the CLI's pinned
   helpers with no host sync (torch's sync debug mode, a prototype that
   does not see every sync, raises on the ones it sees);
   depth finite and >= 0.5 m, and the uint16 codes within one code of the
   dense float32 uplink's.
7. Training (``SemiSupEdgeModel``; no kernel lies on this path: the NMS
   kernel must launch 0 times).
   a. One ``train_step`` at [2,64,96], channels (16,)*6, dropout 0,
      ``flip_lr_prob`` 0, on the card and on the CPU from the same weights
      and batch (``tests/test_torch_train_cuda.py``): loss rtol 1e-4,
      gradients within 1e-4 of each tensor's largest, parameters after the
      Adam step within lr * 1e-2, SAN running statistics rtol 1e-4.
   b. Full width: the task of ``configs/train_packnet_san_kitti_with_edges.yaml``
      with ``arch.precision`` float32 (dropout 0.5, ``flip_lr_prob`` 0.5,
      edge weight 10, GradLoss at 4 scales with normals, sparse-silog, Adam
      lr 1e-4), random weights from its seed, one seeded synthetic batch
      made on the card (batch 3, 384x1280, a blocky depth scene, LiDAR 95 %
      sparse, GT 75 % sparse, edges and normals at the 4 scales): 2 warm-up
      steps (cuDNN's autotuner), 5 timed by CUDA events, then the
      forward, the loss, the backward and the optimizer each timed alone.
      Fails on a non-finite loss or gradient norm, or if no parameter or
      SAN running statistic moved.
   c. The entry point: a 4-frame synthetic GTA split at 384x1280 written to
      ``build/train_smoke/`` (the 8-column format), ``cli.train_edges.main``
      for 1 epoch at batch 2 with the shipped augmentations and validation
      on 2 frames; the checkpoint reloads bit-equal and a resume from it
      starts at epoch 1 with the optimizer's step count restored.
8. The rest of the training family (no kernel on these paths either: the
   NMS kernel must launch 0 times in each).
   a. One ``train_step`` card vs CPU at [2,64,96], channels (16,)*6, as 7a,
      of ``EdgeEstimationLIDARModel`` (DEE), ``SemiSupEdgeCompletionModel``
      and ``SemiSupModel`` at ``supervised_loss_weight`` 0.5 with
      ``PoseNet`` and one back and one forward context image
      (``tests/test_torch_train_cuda.py``); and the photometric loss, card
      vs CPU, its value and its gradients.
   b. DEE training at full width: ``EdgeEstimationLIDARModel`` on the
      network and batch of 7b (LiDAR on, so both passes feed the loss; all
      4 edge scales): 2 warm-up steps, 5 timed, the parts timed alone,
      peak memory.
   c. Self-supervised training at full width: the shipped training config
      at ``supervised_loss_weight`` 0.9 with ``PoseNet``, one back and one
      forward context, batch 3, 384x1280; 7b's batch plus two context
      frames (the scene shifted by 4 and -4 pixels), their originals and
      KITTI intrinsics: as 8b, and the pose network and the photometric
      loss each timed alone.
   d. The entry point on KITTI: a 6-frame synthetic KITTI raw tree at
      96x320 written to ``build/train_smoke_kitti/`` by
      ``tests/test_torch_train_cuda.write_kitti_tree``, then
      ``cli.train_edges.main`` for 1 epoch of ``SemiSupModel`` with
      ``PoseNet`` at batch 2 through
      ``KITTIDataset`` (4 frames with both context frames) and validation;
      the checkpoint holds the pose network and reloads bit-equal.

Prints one line per phase, each phase's wall time, then the card's name
and power limit, a JSON line of the kernels, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits nonzero; without a CUDA
device it exits nonzero and prints no result.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.cli.infer_edge_estimation import annotate_batch
from mindtheedge_tpu_torch.cli import infer_edges, train_edges
from mindtheedge_tpu_torch.cli.infer_edges import infer_batch
from mindtheedge_tpu_torch.config import get_cfg_defaults, parse_train_file
from mindtheedge_tpu_torch.models.packnet import SLIM_CHANNELS, to_train_device
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.ops import edge_ops, wire
from mindtheedge_tpu_torch.ops.cuda import build, nms_kernel
from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint
from mindtheedge_tpu_torch.training.experiment import Experiment
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from tests.test_torch_annotate_cuda import (
    annotate_card_vs_cpu, random_frames, task_config)
from tests.test_torch_train_cuda import write_kitti_tree
from tests.test_torch_nms_kernel import dyadic_patch, gaussian_blur, misaligned
from tests.test_torch_train_cuda import (
    TASKS, kitti_intrinsics, photometric_card_vs_cpu, train_step_card_vs_cpu)

KERNELS = ('nms_kernel',)
B, H, W = 4, 384, 1280
WARMUP, REQUESTS = 2, 5      # phases 4-6; cut from 8 when training joined
DEE_SHAPES = ((1, 192, 640), (1, 96, 320), (1, 48, 160))   # annotation scales
SCALES = 4                      # annotation scales of the DEE network
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
NMS_FLOPS_PER_PX = 40           # separable Sobel-5 pair (32) + bucket tests
TRAIN_CONFIG = 'configs/train_packnet_san_kitti_with_edges.yaml'
TRAIN_B, TRAIN_WARMUP, TRAIN_STEPS = 3, 2, 5   # 10 steps until phase 8 joined
SMOKE_DIR = 'build/train_smoke'
KITTI_DIR = 'build/train_smoke_kitti'
KITTI_H, KITTI_W = 96, 320


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: {what}')


def event_ms(fn, iters):
    """Mean device ms of ``fn(i)`` over ``iters`` back-to-back calls, by CUDA
    events.  The stream first sleeps ~0.5 s so that the host has enqueued
    every call before the first one runs: the events then see device time,
    not the wrapper's launch overhead."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    check(enqueue_s < 0.25, f'enqueueing {iters} calls took {enqueue_s:.3f} s')
    return start.elapsed_time(end) / iters


def nms_bound_ms(numel):
    """(least ms the card could take for NMS of ``numel`` pixels, 'bytes'
    or 'operations'): one f32 read and one write a pixel at 3.35 TB/s, or
    the flops at 67 TFLOP/s, whichever is larger."""
    bytes_ms = 2 * 4 * numel / HBM_BYTES_PER_S * 1e3
    flops_ms = NMS_FLOPS_PER_PX * numel / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), 'bytes' if bytes_ms >= flops_ms else 'operations'


def compare_nms(x):
    """Kernel vs plain version on one card tensor -> (mismatches, max |err|)."""
    got = nms_kernel.non_max_suppression(x)
    torch.cuda.synchronize()
    want = edge_ops.non_max_suppression(x)
    both = (got > 0) & (want > 0)
    check(torch.equal(got[both], want[both]),
          f'kept NMS values differ at {tuple(x.shape)}')
    return (int((got != want).sum()), float((got - want).abs().max()))


def phase_build():
    t0 = time.perf_counter()
    reports = build.build(*KERNELS)
    secs = time.perf_counter() - t0
    for name in KERNELS:
        check(build.library_path(name).exists(), f'{name} did not build')
    print(f'phase 1 build: {len(reports)} of {len(KERNELS)} kernel(s) '
          f'compiled in {secs:.2f} s')
    for name, report in reports.items():
        for line in report.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')


def phase_kernel_vs_plain(dev):
    rng = np.random.RandomState(0)
    noise = rng.rand(B, H, W).astype(np.float32)
    smooth = np.stack([gaussian_blur(n) * 4.0 for n in noise[:2]])
    inputs = {'noise[4,384,1280]': noise, 'smooth[2,384,1280]': smooth}
    for shape in ((2, 192, 640), (2, 96, 320), (2, 48, 160), (3, 37, 53),
                  (2, 70, 130), (1, 5, 7), (4, 3, 3), (2, 11, 4), (1, 9, 124),
                  (4, 383, 1280), (2, 401, 1283)):
        inputs['noise' + str(list(shape)).replace(' ', '')] = (
            rng.rand(*shape).astype(np.float32))
    inputs['misaligned[2,48,160]'] = rng.rand(2, 48, 160).astype(np.float32)
    inputs['misaligned[4,384,1280]'] = rng.rand(B, H, W).astype(np.float32)
    inputs['dyadic[9,9]'] = dyadic_patch()
    total_px = total_bad = 0
    max_err = 0.0
    for name, img in inputs.items():
        x = torch.from_numpy(img).to(dev)
        if name.startswith('misaligned'):
            x = misaligned(x)
        bad, err = compare_nms(x)
        check(bad <= 1e-4 * img.size, f'NMS {name}: {bad} mismatches')
        if name.startswith('dyadic'):
            check(bad == 0, f'NMS {name}: {bad} mismatches')
        total_px, total_bad = total_px + img.size, total_bad + bad
        max_err = max(max_err, err)
        print(f'phase 2 nms kernel vs plain {name}: {bad} of {img.size} '
              f'pixels differ, max |err| {err}')
    return total_px, total_bad, max_err


def phase_small_slice(dev):
    cpu_model = serve.build((16,) * 6, device='cpu', seed=1)
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.RandomState(1)
    rgb_u8 = torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8))
    lidar = rng.rand(2, 64, 96, 1).astype(np.float32) * 80.0
    lidar[rng.rand(2, 64, 96, 1) < 0.95] = 0.0
    lidar = torch.from_numpy(lidar)
    rgb = rgb_u8.float() / 255.0
    with torch.no_grad():
        want = cpu_model(rgb, lidar)['inv_depths']
        got = card_model(rgb.to(dev), lidar.to(dev))['inv_depths']
    worst = 0.0
    for scale, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f'scale {scale}: {m}')
        worst = max(worst, float((g.cpu() - w).abs().max()))
    depth_c, edges_c = serve.serve(card_model, rgb_u8, lidar)
    depth_h, edges_h = serve.serve(cpu_model, rgb_u8, lidar)
    dq = (depth_c.cpu().to(torch.int64) - depth_h.to(torch.int64)).abs().max()
    agree = (wire.unpack_edges(edges_c.cpu()) == wire.unpack_edges(edges_h)
             ).float().mean().item()
    check(int(dq) <= 1 and agree >= 0.99,
          f'small serve card vs cpu: depth codes differ by {int(dq)}, '
          f'edges agree on {agree:.5f}')
    print(f'phase 3 small slice card vs cpu: 4 scales within rtol 1e-4 '
          f'atol 1e-5 (max |err| {worst}); serve depth codes within '
          f'{int(dq)}, edge bits agree on {agree:.6f}')
    shares = annotate_card_vs_cpu(dev)
    for scale, (edge, normals) in enumerate(shares):
        check(edge >= 0.999 and normals >= 0.999,
              f'small annotate_batch card vs cpu, scale {scale}: edges within '
              f'1e-4 on {edge:.5f}, normals within one code on {normals:.5f}')
    print('phase 3 small annotate_batch card vs cpu [2,64,96]: edges within '
          '1e-4 on '
          + ', '.join(f'{e:.5f}' for e, _ in shares) + '; normals within one '
          'code on ' + ', '.join(f'{n:.5f}' for _, n in shares)
          + ' (scales 0-3); hysteresis bit-equal')


def phase_serve(dev):
    model = serve.build(SLIM_CHANNELS, device=dev, seed=0)
    rng = np.random.RandomState(0)
    rgb_base = rng.randint(0, 256, (B, H, W, 3)).astype(np.int64)
    lidar_base = rng.rand(B, H, W, 1).astype(np.float32) * 80.0
    lidar_base[rng.rand(B, H, W, 1) < 0.95] = 0.0
    requests = [
        (torch.from_numpy(((rgb_base + i) % 256).astype(np.uint8)).pin_memory(),
         torch.from_numpy(lidar_base + np.float32(i * 1e-3) * (lidar_base > 0)
                          ).pin_memory())
        for i in range(WARMUP + REQUESTS)]

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.launches = 0
    device_ms, wall_ms = [], []
    for i, (rgb_u8, lidar) in enumerate(requests):
        if i == WARMUP:     # the warm-up peak holds cuDNN's autotuning
            tuning_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start.record()
        depth_wire, edges_wire = serve.serve(model, rgb_u8, lidar, wire='u16')
        depth_host, edges_host = depth_wire.cpu(), edges_wire.cpu()
        end.record()
        end.synchronize()
        if i >= WARMUP:
            device_ms.append(start.elapsed_time(end))
            wall_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nms_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == WARMUP + REQUESTS,
          f'NMS kernel launched {launches} times in {WARMUP + REQUESTS} requests')

    check(depth_host.dtype == torch.uint16 and depth_host.shape == (B, H, W),
          f'depth wire {depth_host.dtype} {tuple(depth_host.shape)}')
    check(edges_host.dtype == torch.uint8 and edges_host.shape == (B, H, W // 8),
          f'edge wire {edges_host.dtype} {tuple(edges_host.shape)}')
    depth = wire.decode_depth_u16(depth_host)
    edge_share = wire.unpack_edges(edges_host).float().mean().item()
    check(bool(torch.isfinite(depth).all()) and float(depth.min()) >= 0.5,
          f'depth out of range [{float(depth.min())}, {float(depth.max())}]')
    check(edge_share < 0.5, f'edge share {edge_share}')
    mean_ms = float(np.mean(device_ms))
    print(f'phase 4 serve 384x1280 b{B} fp32: {REQUESTS} requests after '
          f'{WARMUP} warm-up, {mean_ms:.3f} ms/batch on the device '
          f'(min {min(device_ms):.3f}, max {max(device_ms):.3f}; host wall '
          f'{float(np.mean(wall_ms)):.3f}), {B * 1e3 / mean_ms:.2f} img/s, '
          f'peak {peak / 2**30:.3f} GiB (warm-up with cuDNN autotuning '
          f'{tuning_peak / 2**30:.3f} GiB), nms launches {launches} '
          f'({launches / (WARMUP + REQUESTS):g} per request), depth '
          f'[{float(depth.min()):.3f}, {float(depth.max()):.3f}] m, '
          f'edge share {edge_share:.4f}')

    # the kernel on the probability map the main path gave it
    rgb_u8, lidar = requests[-1]
    with torch.no_grad():
        inv = model(rgb_u8.to(dev).float() / 255.0, lidar.to(dev))[
            'inv_depths'][0][..., 0]
    prob = torch.clamp(inv / 2.0, 0.0, 1.0)
    bad, err = compare_nms(prob)
    check(bad <= 1e-4 * prob.numel(), f'NMS on the served map: {bad} mismatches')
    kept = (edge_ops.non_max_suppression(prob) > 0).float().mean().item()
    check(0.0 < kept < 1.0, f'NMS kept {kept} of the served map')
    print(f'phase 4 nms kernel vs plain on the served map: {bad} of '
          f'{prob.numel()} pixels differ, max |err| {err}; NMS keeps {kept:.4f}')
    return launches, prob, bad, err


def profiled_kernel_us(fn, iters):
    """(CUDA-events mean ms of ``event_ms(fn, iters)`` run under
    ``torch.profiler``, the profiler's mean device us of the NMS kernel in
    that run, or None where it shows no device time)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms = event_ms(fn, iters)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and 'nms_sobel5_kernel' in e.key]
    count = sum(e.count for e in rows)
    if not count or not sum(e.self_device_time_total for e in rows):
        return ms, None
    return ms, sum(e.self_device_time_total for e in rows) / count


def time_nms(prob):
    """Kernel and plain version at [4,384,1280] on 8 inputs in turn, 63 MB,
    more than the 50 MB L2, so each call reads its input from HBM; then the
    kernel on the served map ``prob`` (warm in L2, as on the main path), a
    copy of the same bytes, the kernel at the DEE annotation scales (one
    input each), and last the 8-input run again under ``torch.profiler``."""
    dev = prob.device
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand(B, H, W, device=dev, generator=gen) for _ in range(8)]
    for x in xs:
        nms_kernel.non_max_suppression(x)
        edge_ops.non_max_suppression(x)
    rotate = lambda i: nms_kernel.non_max_suppression(xs[i % 8])
    kernel_ms = event_ms(rotate, 400)
    plain_ms = event_ms(lambda i: edge_ops.non_max_suppression(xs[i % 8]), 4)
    warm_ms = event_ms(lambda i: nms_kernel.non_max_suppression(prob), 400)
    # a yardstick, not the function: moving the same bytes, device to device
    copy_to = torch.empty_like(xs[0]).copy_(xs[0])
    copy_ms = event_ms(lambda i: copy_to.copy_(xs[i % 8]), 400)
    bound_ms, bound_by = nms_bound_ms(B * H * W)
    print(f'nms timing [4,384,1280], 8 inputs in turn: kernel '
          f'{kernel_ms * 1e3:.3f} us by CUDA events, bound '
          f'{bound_ms * 1e3:.3f} us ({bound_by}), '
          f'{100 * bound_ms / kernel_ms:.1f} % of bound; plain '
          f'{plain_ms * 1e3:.2f} us')
    print(f'nms timing on the served map {list(prob.shape)}, warm in L2: '
          f'{warm_ms * 1e3:.3f} us')
    print(f'copy of the same bytes [4,384,1280] (torch copy_, 8 inputs in '
          f'turn): {copy_ms * 1e3:.3f} us')
    for shape in DEE_SHAPES:
        x = torch.rand(*shape, device=dev, generator=gen)
        nms_kernel.non_max_suppression(x)
        ms = event_ms(lambda i: nms_kernel.non_max_suppression(x), 400)
        bound, _ = nms_bound_ms(x.numel())
        print(f'nms timing {list(shape)}: {ms * 1e3:.3f} us per launch, '
              f'bound {bound * 1e3:.3f} us')
    prof_events_ms, prof_us = profiled_kernel_us(rotate, 400)
    print(f'nms timing [4,384,1280] under torch.profiler: CUDA events '
          f'{prof_events_ms * 1e3:.3f} us per launch, kernel duration '
          + ('not shown (the profiler shows no device time)' if prof_us is None
             else f'{prof_us:.3f} us, gap between launches '
                  f'{prof_events_ms * 1e3 - prof_us:.3f} us'))
    return kernel_ms, plain_ms, bound_ms, bound_by


def sync_ms(fn, iters):
    """Mean ms of ``fn(i)`` over ``iters`` calls by CUDA events, for work
    that waits for the card itself (so ``event_ms``'s enqueue check cannot
    hold): events around the calls, then wait."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def frames(seed, i, scale_lidar=1.0):
    """Batch ``i`` of a seeded full-width stream, pinned: rgb shifted by
    i/256 and set LiDAR points moved by i/256 m (staying on the uint16 PNG
    grid), the LiDAR then multiplied by ``scale_lidar``."""
    rgb, lidar = random_frames(np.random.RandomState(seed), B, H, W)
    rgb = (rgb + i / 256.0) % 1.0
    lidar = (lidar + (i / 256.0) * (lidar > 0)) * scale_lidar
    return rgb.pin_memory(), lidar.pin_memory()


def phase_annotate(dev, kernel_ms):
    """The DEE annotation path at full width -> (launches, checked pixels,
    mismatches, max |err|)."""
    task = build_task(task_config('EdgeEstimationLIDARModel'), device=dev)
    batches = [frames(5, i, 1.0 / 200.0) for i in range(WARMUP + REQUESTS)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    nms_kernel.launches = 0
    device_ms, wall_ms = [], []
    for i, (rgb, lidar) in enumerate(batches):
        if i == WARMUP:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start.record()
        results = annotate_batch(task, rgb.to(dev, non_blocking=True),
                                 lidar.to(dev, non_blocking=True))
        host = [(r['edge'].cpu(), r['normals'].cpu()) for r in results]
        end.record()
        end.synchronize()
        if i >= WARMUP:
            device_ms.append(start.elapsed_time(end))
            wall_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nms_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == SCALES * len(batches),
          f'NMS kernel launched {launches} times in {len(batches)} '
          f'annotation batches')
    for s, (edge, normals) in enumerate(host):
        shape = (B, H >> s, W >> s)
        check(tuple(edge.shape) == shape and tuple(normals.shape) == shape,
              f'scale {s}: edge {tuple(edge.shape)} normals {tuple(normals.shape)}')
        check(bool(torch.isfinite(edge).all()) and 0.0 <= float(edge.min())
              and float(edge.max()) <= 1.0 and float(edge.max()) > 0.0,
              f'scale {s}: edge values [{float(edge.min())}, {float(edge.max())}]')
        check(0.0 <= float(normals.min()) and float(normals.max()) <= 255.0,
              f'scale {s}: normal codes out of [0, 255]')
    counts = [r['hysteresis'] for r in results]
    syncs = sum(c for _, c in counts) + 2 * SCALES
    mean_ms = float(np.mean(device_ms))
    print(f'phase 5 annotate 384x1280 b{B} fp32, 4 scales, NMS + hysteresis + '
          f'normals: {REQUESTS} batches after {WARMUP} warm-up, '
          f'{mean_ms:.3f} ms/batch by CUDA events (min {min(device_ms):.3f}, '
          f'max {max(device_ms):.3f}; host wall {float(np.mean(wall_ms)):.3f}), '
          f'{B * 1e3 / mean_ms:.2f} img/s, peak {peak / 2**30:.3f} GiB, nms '
          f'launches {launches} ({launches / len(batches):g} per batch), '
          f'hysteresis (iterations, checks) per scale {counts}, host syncs '
          f'per batch {syncs} ({syncs - 2 * SCALES} hysteresis checks + '
          f'{2 * SCALES} read-backs)')

    # the last batch again, outside the counted run: each scale's kernel
    # output against the plain version, and hysteresis card vs CPU
    rgb, lidar = batches[-1]
    batch = {'rgb': rgb.to(dev), 'input_depth': lidar.to(dev)}
    forward_ms = sync_ms(lambda i: task.run_depth(batch), 3)
    inv = task.run_depth(batch)
    px = bad = 0
    max_err = 0.0
    stage_ms = {'nms': [], 'normals': [], 'hysteresis': [], 'read-back': []}
    for s in range(SCALES):
        prob = inv['inv_depths'][s][..., 0] / 2.0
        n_bad, err = compare_nms(prob)
        check(n_bad <= 1e-4 * prob.numel(), f'scale {s} NMS: {n_bad} mismatches')
        px, bad, max_err = px + prob.numel(), bad + n_bad, max(max_err, err)
        nms = nms_kernel.non_max_suppression(prob)
        on_card, iters, checks = edge_ops.hysteresis_counted(nms)
        check(torch.equal(on_card.cpu(), edge_ops.hysteresis(nms.cpu())),
              f'scale {s}: hysteresis differs card vs CPU')
        hyst_ms = sync_ms(lambda i: edge_ops.hysteresis_counted(nms), 5)
        by_interval = {k: sync_ms(lambda i: edge_ops.hysteresis_counted(
            nms, check_every=k), 5) for k in (1, 16)}
        stage_ms['hysteresis'].append(hyst_ms)
        stage_ms['nms'].append(kernel_ms if s == 0 else event_ms(
            lambda i: nms_kernel.non_max_suppression(prob), 400))
        stage_ms['normals'].append(event_ms(
            lambda i: edge_ops.normals_angle_255(prob), 20))
        stage_ms['read-back'].append(sync_ms(lambda i: (nms.cpu(), nms.cpu()), 5))
        print(f'phase 5 scale {s} {list(prob.shape)}: NMS kernel vs plain '
              f'{n_bad} of {prob.numel()} pixels differ, max |err| {err}; '
              f'kernel {stage_ms["nms"][-1] * 1e3:.3f} us'
              + (' (8 inputs in turn, nms timing above)' if s == 0 else
                 ' (warm in L2)') + f'; hysteresis bit-equal card vs CPU, '
              f'{iters} iterations, {checks} checks of every '
              f'{edge_ops.CHECK_EVERY} steps {hyst_ms:.3f} ms; checks of '
              + ', '.join(f'every {k} {v:.3f} ms' for k, v in by_interval.items())
              + f'; normals '
              f'{stage_ms["normals"][-1]:.3f} ms; read-back of edge and '
              f'normals {stage_ms["read-back"][-1]:.3f} ms')
    share = 100 * sum(stage_ms['nms']) / mean_ms
    print(f'phase 5 NMS kernel per annotation batch: {SCALES} launches, '
          f'{sum(stage_ms["nms"]) * 1e3:.3f} us, {share:.4f} % of the batch')
    print(f'phase 5 where an annotation batch goes (each stage timed alone, '
          f'ms): forward {forward_ms:.3f}, '
          + ', '.join(f'{k} {sum(v):.3f}' for k, v in stage_ms.items())
          + f'; the rest (uploads, scale halving, launch gaps) '
          f'{mean_ms - forward_ms - sum(map(sum, stage_ms.values())):.3f}')
    return launches, px, bad, max_err


def phase_infer(dev):
    """The batch-inference path at full width, sparse uint16 LiDAR up and
    uint16 depth down, through the CLI's own upload and read-back; the
    timed batches run with torch's sync debug mode on 'error', so any host
    sync on the path fails the phase -> NMS launches (none on this path)."""
    task = build_task(task_config('SemiSupEdgeModel'), device=dev)
    cap = H * W // 8
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    nms_kernel.launches = 0
    device_ms, encode_ms = [], []
    for i in range(WARMUP + REQUESTS):
        rgb, lidar = frames(6, i)
        t0 = time.perf_counter()
        pairs = [wire.encode_lidar_sparse(l.numpy(), cap) for l in lidar]
        idx = np.stack([p[0] for p in pairs]).view(np.int32)
        val = np.stack([p[1] for p in pairs])
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode('error' if i >= WARMUP else 0)
        start.record()
        sparse = (infer_edges.upload(idx, dev), infer_edges.upload(val, dev))
        depth_host, done = infer_edges.start_readback(infer_batch(
            task, infer_edges.upload(rgb.numpy(), dev), sparse, 'u16'))
        end.record()
        torch.cuda.set_sync_debug_mode(0)
        end.synchronize()
        check(done.query(), 'read-back not complete at the end event')
        if i >= WARMUP:
            device_ms.append(start.elapsed_time(end))
            encode_ms.append((t1 - t0) * 1e3)
    launches = nms_kernel.launches
    check(depth_host.dtype == torch.uint16 and depth_host.shape == (B, H, W),
          f'depth wire {depth_host.dtype} {tuple(depth_host.shape)}')
    depth = wire.decode_depth_u16(depth_host)
    check(bool(torch.isfinite(depth).all()) and float(depth.min()) >= 0.5,
          f'depth out of range [{float(depth.min())}, {float(depth.max())}]')
    dense = infer_batch(task, rgb.to(dev), lidar.to(dev), 'u16').cpu()
    codes = int((dense.to(torch.int64) - depth_host.to(torch.int64)).abs().max())
    check(codes <= 1, f'sparse vs dense uplink: u16 codes differ by {codes}')
    mean_ms = float(np.mean(device_ms))
    print(f'phase 6 infer 384x1280 b{B} fp32, sparse u16 LiDAR up ({cap} '
          f'slots a frame), u16 depth down: {REQUESTS} batches after {WARMUP} '
          f'warm-up, no host sync on the path (sync debug mode), '
          f'{mean_ms:.3f} ms/batch by CUDA events (min {min(device_ms):.3f}, '
          f'max {max(device_ms):.3f}), {B * 1e3 / mean_ms:.2f} img/s; host '
          f'sparse encode {float(np.mean(encode_ms)):.3f} ms/batch; depth '
          f'[{float(depth.min()):.3f}, {float(depth.max()):.3f}] m; u16 codes '
          f'within {codes} of the dense float32 uplink; nms launches {launches}')
    return launches


def phase_train_small(dev):
    loss_h, loss_c, worst = train_step_card_vs_cpu(dev)
    print(f'phase 7a train_step card vs cpu [2,64,96] (16,)*6: loss {loss_c} on '
          f'the card, {loss_h} on the CPU; worst gradient error '
          f'{worst["grad_vs_max"]:.3e} of its tensor\'s largest |gradient| '
          f'(bound 1e-4); worst parameter error after the Adam step '
          f'{worst["param_vs_lr"]:.3e} lr (bound 1e-2); SAN running stats '
          f'within rtol 1e-4')


def train_config():
    """The shipped training config in strict fp32, random weights."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(TRAIN_CONFIG)
    cfg.arch.precision = 'float32'
    cfg.model.depth_net.checkpoint_path = ''
    return cfg


def blocky_scene(rng, b, h, w, dev):
    """[b,h,w] depth in metres on the card: 30 m with 12 boxes of 5-25 m."""
    depth = torch.full((b, h, w), 30.0, device=dev)
    for i in range(b):
        for _ in range(12):
            y, x = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
            hh, ww = rng.randint(h // 16, h // 3), rng.randint(w // 16, w // 3)
            depth[i, y:y + hh, x:x + ww] = float(rng.uniform(5.0, 25.0))
    return depth


def full_width_batch(dev, seed=0):
    """A seeded synthetic training batch made on the card, NHWC: RGB shaded
    by depth, LiDAR 95 % sparse, GT 75 % sparse, and at each of the 4
    scales the depth edges (a step to the right or below) and the normals
    (the Sobel-5 angle of the scene, as the DEE annotation decodes it)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    b, h, w = TRAIN_B, H, W
    depth = blocky_scene(rng, b, h, w, dev)
    shade = (depth / 40.0)[..., None]
    batch = {'rgb': torch.clamp(shade + 0.2 * torch.rand(b, h, w, 3, device=dev,
                                                        generator=gen), 0.0, 1.0)}
    keep = lambda share: torch.rand(b, h, w, device=dev, generator=gen) < share
    batch['input_depth'] = torch.where(keep(0.05), depth, 0.0)[..., None]
    batch['depth'] = torch.where(keep(0.25), depth, 0.0)[..., None]
    for s, key in enumerate(('', '_1', '_2', '_3')):
        d = depth[:, ::2 ** s, ::2 ** s].contiguous()
        edge = torch.zeros_like(d, dtype=torch.bool)
        edge[:, :, :-1] |= d[:, :, 1:] != d[:, :, :-1]
        edge[:, :-1] |= d[:, 1:] != d[:, :-1]
        batch['edge' + key] = edge.float()[..., None]
        batch['normal' + key] = edge_ops.decode_normal_png(
            edge_ops.normals_angle_255(d))[..., None]
    return batch


def stage_ms(task, state, batch, gen):
    """The forward, the loss, the backward and the optimizer step of one
    training step, each timed alone by CUDA events between syncs (ms); for
    a task with a pose network, then the pose network's forward and the
    photometric loss (pose network included) each alone."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(12)]
    for net in state.networks():
        net.zero_grad(set_to_none=False)

    def timed(i, fn):
        torch.cuda.synchronize()
        events[2 * i].record()
        out = fn()
        events[2 * i + 1].record()
        torch.cuda.synchronize()
        return out

    batch = task.prep_batch(batch)
    out = timed(0, lambda: task.run_depth(batch, train=True, generator=gen))
    total, _ = timed(1, lambda: task.losses(batch, out))
    names = ['forward', 'loss', 'backward', 'optimizer']
    if task.pose_net is not None:
        timed(4, lambda: task.run_pose(batch))
        timed(5, lambda: task._self_sup_loss(batch, out, task.run_pose(batch)))
        names += ['pose net', 'photometric loss']
    del out
    timed(2, total.backward)
    timed(3, state.optimizer.step)
    return {n: events[2 * i].elapsed_time(events[2 * i + 1]) for i, n in enumerate(names)}


def train_full(dev, cfg, batch, label):
    """``TRAIN_WARMUP`` + ``TRAIN_STEPS`` full-width training steps of the
    task of ``cfg`` on ``batch`` -> (mean ms per step, peak bytes, rows of
    metrics, the step's parts timed alone, a summary line)."""
    task = build_task(cfg, device=dev)
    net = to_train_device(task.depth_net, dev)
    state = create_train_state(cfg, net, pose_net=task.pose_net)
    step = make_train_step(task)
    gen = torch.Generator(dev).manual_seed(cfg.arch.seed)
    params = state.parameters()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        step(state, batch, gen)
    torch.cuda.synchronize()
    tuning_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = [p.detach().clone() for p in params]
    running = lambda: [b for n in state.networks() for k, b in n.named_buffers() if 'running' in k]
    stats_before = [b.clone() for b in running()]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(TRAIN_STEPS):
        metrics.append(step(state, batch, gen))
        events[i + 1].record()
    events[-1].synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_STEPS)]
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for r in rows:
        check(all(np.isfinite(v) for v in r.values()), f'{label}: non-finite metrics {r}')
    moved = sum(not torch.equal(p.detach(), q) for p, q in zip(params, before))
    stats_moved = sum(not torch.equal(b, a) for b, a in zip(running(), stats_before))
    check(moved > 0 and (stats_moved > 0 or not stats_before),
          f'{label}: {moved} parameter tensors and {stats_moved} running statistics moved')
    mean_ms = float(np.mean(step_ms))
    stages = stage_ms(task, state, batch, gen)
    line = (f'{label} {H}x{W} b{TRAIN_B} fp32 (TF32 off), {sum(p.numel() for p in params)} '
            f'parameters, dropout {cfg.model.depth_net.dropout}, flip '
            f'{cfg.model.loss.flip_lr_prob}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} '
            f'warm-up, {mean_ms:.3f} ms/step by CUDA events (min {min(step_ms):.3f}, '
            f'max {max(step_ms):.3f}), {TRAIN_B * 1e3 / mean_ms:.3f} img/s, peak '
            f'{peak / 2**30:.3f} GiB (warm-up with cuDNN autotuning '
            f'{tuning_peak / 2**30:.3f} GiB); {moved} of {len(before)} parameter tensors '
            f'and {stats_moved} of {len(stats_before)} running statistics moved')
    print(line)
    for i, r in enumerate(rows):
        print(f'{label} step {i}: {step_ms[i]:.3f} ms, '
              + ', '.join(f'{k} {v:.6f}' for k, v in sorted(r.items())))
    main = ('forward', 'loss', 'backward', 'optimizer')
    total = sum(stages[k] for k in main)
    print(f'{label} where a training step goes (each part timed alone, ms): '
          + ', '.join(f'{k} {stages[k]:.3f} ({100 * stages[k] / total:.1f} %)' for k in main)
          + f'; sum {total:.3f} vs {mean_ms:.3f} per step in the run'
          + ''.join(f'; {k} alone {v:.3f}' for k, v in stages.items() if k not in main))
    return mean_ms, peak


def phase_train_full(dev):
    return train_full(dev, train_config(), full_width_batch(dev), 'phase 7b train')


def phase_train_small_tasks(dev):
    """8a: one step card vs CPU of each new task, and the photometric loss."""
    for task, (_, _, floor) in TASKS.items():
        loss_h, loss_c, worst = train_step_card_vs_cpu(dev, task=task)
        bound = '1e-4' + (f', or {floor:g} of the network\'s largest' if floor else '')
        print(f'phase 8a {task} train_step card vs cpu [2,64,96] (16,)*6: loss '
              f'{loss_c} on the card, {loss_h} on the CPU; worst gradient error '
              f'{worst["grad_vs_max"]:.3e} of its tensor\'s largest |gradient| (bound '
              f'{bound}); worst parameter error after the Adam step '
              f'{worst["param_vs_lr"]:.3e} lr (bound 1e-2); running stats within rtol 1e-4')
    worst = photometric_card_vs_cpu(dev)
    print(f'phase 8a photometric loss card vs cpu [2,64,96], 4 scales, 2 contexts, zeros '
          f'and border padding: values within rtol 1e-5, worst gradient error {worst:.3e} '
          f'of its tensor\'s largest |gradient| (bound 3e-4)')


def phase_train_dee(dev):
    cfg = train_config()
    cfg.model.name = 'EdgeEstimationLIDARModel'
    return train_full(dev, cfg, full_width_batch(dev), 'phase 8b DEE train')


def selfsup_config():
    """The shipped training config at supervised_loss_weight 0.9 with
    PoseNet and one back and one forward context frame."""
    cfg = train_config()
    cfg.model.loss.supervised_loss_weight = 0.9
    cfg.model.pose_net.name = 'PoseNet'
    cfg.datasets.train.back_context = cfg.datasets.train.forward_context = 1
    return cfg


def phase_train_selfsup(dev):
    batch = full_width_batch(dev)
    batch['rgb_original'] = batch['rgb']
    batch['rgb_context'] = [torch.roll(batch['rgb'], shift, dims=2) for shift in (4, -4)]
    batch['rgb_context_original'] = batch['rgb_context']
    batch['intrinsics'] = torch.from_numpy(kitti_intrinsics(TRAIN_B, H, W)).to(dev)
    return train_full(dev, selfsup_config(), batch, 'phase 8c self-supervised train')


def phase_train_kitti_cli(dev):
    import os
    import shutil
    shutil.rmtree(KITTI_DIR, ignore_errors=True)
    tree = os.path.join(KITTI_DIR, 'kitti')
    split = write_kitti_tree(tree, n_frames=6, h=KITTI_H, w=KITTI_W, no_gt=())
    cfg = selfsup_config()
    cfg.model.name = 'SemiSupModel'
    cfg.arch.max_epochs = 1
    cfg.edges.depth_edges_metric_log = False
    cfg.datasets.augmentation.image_shape = (KITTI_H, KITTI_W)
    cfg.datasets.train.batch_size = 2
    for mode in ('train', 'validation'):
        ds = cfg.datasets[mode]
        ds.dataset, ds.path, ds.split = ['KITTI'], [tree], [split]
    cfg.checkpoint.filepath = os.path.join(KITTI_DIR, 'checkpoints')
    yaml_path = os.path.join(KITTI_DIR, 'train.yaml')
    cfg.save_yaml(yaml_path)
    t0 = time.perf_counter()
    exp = train_edges.main([yaml_path], device=dev)
    secs = time.perf_counter() - t0
    check(len(exp.train_loader.dataset) == 4 and exp.state.step == 2,
          f'{len(exp.train_loader.dataset)} KITTI frames with context, {exp.state.step} steps')
    ckpts = sorted(f for f in os.listdir(cfg.checkpoint.filepath) if f.endswith('.ckpt'))
    check(len(ckpts) == 1, f'checkpoints written: {ckpts}')
    ckpt = load_checkpoint(os.path.join(cfg.checkpoint.filepath, ckpts[0]))
    own = {f'model.{tag}.{k}': v for tag, net in (('depth_net', exp.state.net),
                                                  ('pose_net', exp.state.pose_net))
           for k, v in net.state_dict().items()}
    check(set(own) == set(ckpt['state_dict'])
          and all(torch.equal(ckpt['state_dict'][k], v.cpu()) for k, v in own.items()),
          'the KITTI checkpoint does not hold both networks bit-equal')
    print(f'phase 8d train_edges.main SemiSupModel + PoseNet on a synthetic KITTI tree '
          f'{KITTI_H}x{KITTI_W}, 6 frames (4 with both context frames), batch 2, 1 epoch '
          f'with validation: {secs:.1f} s; wrote {ckpts[0]} with '
          f'{sum(k.startswith("model.pose_net.") for k in own)} pose-network entries, '
          f'reloads bit-equal')


def write_split(root, n, h, w, seed=0):
    """``n`` frames of a blocky scene in the GTA split format (rgb, uint16
    depth, edges and normals with their ``_001..003`` scales, uint16
    LiDAR), written with cv2 -> the split file."""
    import cv2
    import os
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scenes = blocky_scene(rng, n, h, w, 'cpu').numpy()
    lines = []
    for i, depth in enumerate(scenes):
        f = lambda tag: os.path.join(root, f'{i:06d}_{tag}.png')
        rgb = np.clip(depth * 6 + rng.randn(h, w) * 8, 0, 255)
        cv2.imwrite(f('rgb'), np.stack([rgb] * 3, -1).astype(np.uint8))
        cv2.imwrite(f('depth'), (depth * 256).astype(np.uint16))
        lidar = np.where(rng.rand(h, w) < 0.05, depth, 0.0)
        cv2.imwrite(f('lidar'), (lidar * 256).astype(np.uint16))
        edge = cv2.Canny((depth * 255 / 30).astype(np.uint8), 20, 40)
        sx = cv2.Sobel(depth.astype(np.float64), cv2.CV_64F, 1, 0, ksize=5)
        sy = cv2.Sobel(depth.astype(np.float64), cv2.CV_64F, 0, 1, ksize=5)
        normal = ((np.arctan2(-sy, sx) * 180 / np.pi + 180) / 360 * 255).astype(np.uint8)
        for s in range(4):
            size = (w >> s, h >> s)
            cv2.imwrite(f(f'edge_00{s}'), cv2.resize(edge, size, interpolation=cv2.INTER_NEAREST))
            cv2.imwrite(f(f'normal_00{s}'), cv2.resize(normal, size))
        lines.append(f'{f("rgb")} {f("depth")} {f("edge_000")} {f("lidar")} None None '
                     f'None {f("normal_000")}\n')
    path = os.path.join(root, 'split.txt')
    with open(path, 'w') as fh:
        fh.writelines(lines)
    with open(os.path.join(root, 'val.txt'), 'w') as fh:
        fh.writelines(lines[:2])
    return path, os.path.join(root, 'val.txt')


def phase_train_cli(dev):
    import os
    import shutil
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    split, val = write_split(os.path.join(SMOKE_DIR, 'data'), 4, H, W)
    cfg = train_config()
    cfg.arch.max_epochs = 1
    cfg.datasets.train.batch_size = 2
    cfg.datasets.train.path, cfg.datasets.train.split = [''], [split]
    cfg.datasets.validation.path, cfg.datasets.validation.split = [''], [val]
    cfg.checkpoint.filepath = os.path.join(SMOKE_DIR, 'checkpoints')
    yaml_path = os.path.join(SMOKE_DIR, 'train.yaml')
    cfg.save_yaml(yaml_path)
    t0 = time.perf_counter()
    exp = train_edges.main([yaml_path], device=dev)
    secs = time.perf_counter() - t0
    ckpts = sorted(f for f in os.listdir(cfg.checkpoint.filepath) if f.endswith('.ckpt'))
    check(len(ckpts) == 1, f'checkpoints written: {ckpts}')
    path = os.path.join(cfg.checkpoint.filepath, ckpts[0])
    ckpt = load_checkpoint(path)
    own = exp.state.net.state_dict()
    check(all(torch.equal(ckpt['state_dict'][f'model.depth_net.{k}'], v.cpu())
              for k, v in own.items()) and len(own) == len(ckpt['state_dict']),
          'the checkpoint does not reload bit-equal')
    cfg2, resume = parse_train_file(yaml_path)
    check(resume == path, f'resume picked {resume}')
    state = Experiment(cfg2, resume_ckpt=resume, device=dev).initialize_state()
    steps = {int(s['step']) for s in state.optimizer.state_dict()['state'].values()}
    check(state.epoch == 1 and state.step == 2 and steps == {2},
          f'resumed at epoch {state.epoch}, step {state.step}, Adam steps {steps}')
    print(f'phase 7c train_edges.main {H}x{W}, 4 frames, batch 2, 1 epoch with '
          f'validation on 2 frames: {secs:.1f} s; wrote {ckpts[0]}, reloads bit-equal; '
          f'resume starts at epoch {state.epoch}, step {state.step}, Adam step count '
          f'{steps.pop()}')


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(), 'nvidia-smi failed')
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    print(f'torch {torch.__version__} cuda {torch.version.cuda} on '
          f'{torch.cuda.get_device_name(0)}')
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        return out

    timed('1', phase_build)
    px2, bad2, err2 = timed('2', phase_kernel_vs_plain, dev)
    timed('3', phase_small_slice, dev)
    launches4, prob, bad4, err4 = timed('4', phase_serve, dev)
    kernel_ms, plain_ms, bound_ms, bound_by = timed('nms timing', time_nms, prob)
    launches5, px5, bad5, err5 = timed('5', phase_annotate, dev, kernel_ms)
    launches6 = timed('6', phase_infer, dev)
    nms_kernel.launches = 0
    timed('7a', phase_train_small, dev)
    timed('7b', phase_train_full, dev)
    timed('7c', phase_train_cli, dev)
    launches7 = nms_kernel.launches
    check(launches7 == 0, f'NMS kernel launched {launches7} times on the training path')
    launches8 = 0
    for name, fn in (('8a', phase_train_small_tasks), ('8b', phase_train_dee),
                     ('8c', phase_train_selfsup), ('8d', phase_train_kitti_cli)):
        nms_kernel.launches = 0
        timed(name, fn, dev)
        check(nms_kernel.launches == 0,
              f'NMS kernel launched {nms_kernel.launches} times in phase {name}')
        launches8 += nms_kernel.launches
    print(f'NMS launches on the phase-8 training paths (DEE, completion, '
          f'self-supervised): {launches8}')
    print('phase wall times (s): ' + ', '.join(f'{k} {v:.1f}' for k, v in walls.items()))
    print(f'chip_smoke wall time {time.perf_counter() - t0:.1f} s')
    card = card_line()
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'nms_sobel5', 'route': 'cuda',
        'source': 'mindtheedge_tpu_torch/csrc/nms_kernel.cu',
        'replaces': 'mindtheedge_tpu/ops/pallas/nms_kernel.py:111',
        'launches': launches4 + launches5 + launches6 + launches7 + launches8,
        'launches_by_path': {'serve': launches4, 'annotate': launches5,
                             'infer': launches6, 'train': launches7,
                             'train_dee_completion_selfsup': launches8},
        'max_abs_err': max(err2, err4, err5),
        'mismatched_px': bad2 + bad4 + bad5,
        'checked_px': px2 + prob.numel() + px5,
        'tolerance': 'agree on >= 99.99% of pixels, kept values bit-equal',
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': None}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
