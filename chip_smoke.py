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
   first one runs cuDNN's autotuner) and 8 timed ones through
   ``serve.serve``, rgb and LiDAR perturbed on every request; the NMS
   kernel must launch once per request.  Then time the kernel: at
   [4,384,1280] on 8 inputs in turn (more than L2) by CUDA events, and by
   ``torch.profiler`` over the same kind of run; on the served map, warm in
   L2 as on the main path; at the DEE scales; and its plain version.
5. The DEE annotation path at full width (``EdgeEstimationLIDARModel``, the
   same network, LiDAR /200): 2 warm-up and 8 timed batches through
   ``cli.infer_edge_estimation.annotate_batch`` (forward, then at each of
   the 4 scales normals, the NMS kernel and hysteresis), uploads and
   read-backs included; the NMS kernel must launch 4 times per batch.
   Each scale's NMS map is held against the plain version, and hysteresis
   on the card against hysteresis on the CPU, bit for bit.  Prints ms per
   batch, hysteresis iterations, checks and their cost per scale, host
   syncs per batch, peak memory, the kernel's time at the 4 shapes and
   the time of each stage alone.
6. The batch-inference path at full width (``SemiSupEdgeModel``, the same
   network): 2 warm-up and 8 timed batches through
   ``cli.infer_edges.infer_batch`` with the sparse uint16 LiDAR uplink and
   the uint16 depth downlink, uploaded and read back by the CLI's pinned
   helpers with no host sync (torch's sync debug mode, a prototype that
   does not see every sync, raises on the ones it sees);
   depth finite and >= 0.5 m, and the uint16 codes within one code of the
   dense float32 uplink's.

Prints one line per phase, the wall time, then the card's name and power
limit, a JSON line of the kernels, and as its last line
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
from mindtheedge_tpu_torch.cli import infer_edges
from mindtheedge_tpu_torch.cli.infer_edges import infer_batch
from mindtheedge_tpu_torch.models.packnet import SLIM_CHANNELS
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.ops import edge_ops, wire
from mindtheedge_tpu_torch.ops.cuda import build, nms_kernel
from tests.test_torch_annotate_cuda import (
    annotate_card_vs_cpu, random_frames, task_config)
from tests.test_torch_nms_kernel import dyadic_patch, gaussian_blur, misaligned

KERNELS = ('nms_kernel',)
B, H, W = 4, 384, 1280
WARMUP, REQUESTS = 2, 8
DEE_SHAPES = ((1, 192, 640), (1, 96, 320), (1, 48, 160))   # annotation scales
SCALES = 4                      # annotation scales of the DEE network
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
NMS_FLOPS_PER_PX = 40           # separable Sobel-5 pair (32) + bucket tests


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
    phase_build()
    px2, bad2, err2 = phase_kernel_vs_plain(dev)
    phase_small_slice(dev)
    launches4, prob, bad4, err4 = phase_serve(dev)
    kernel_ms, plain_ms, bound_ms, bound_by = time_nms(prob)
    launches5, px5, bad5, err5 = phase_annotate(dev, kernel_ms)
    launches6 = phase_infer(dev)
    print(f'chip_smoke wall time {time.perf_counter() - t0:.1f} s')
    card = card_line()
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'nms_sobel5', 'route': 'cuda',
        'source': 'mindtheedge_tpu_torch/csrc/nms_kernel.cu',
        'replaces': 'mindtheedge_tpu/ops/pallas/nms_kernel.py:111',
        'launches': launches4 + launches5 + launches6,
        'launches_by_path': {'serve': launches4, 'annotate': launches5,
                             'infer': launches6},
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
