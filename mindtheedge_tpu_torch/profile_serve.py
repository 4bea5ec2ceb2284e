"""Where the serving forward's time goes on the card.

    python -m mindtheedge_tpu_torch.profile_serve [--cudnn-heuristics]

Builds PackNet-SAN 1A at full width (SLIM channels, 384x1280, fp32, TF32
off, random weights from seed 0), answers one warm-up request through
``serve.serve`` at batch 4, then profiles 2 more with ``torch.profiler``.
Prints the device ms per request (CUDA events), the device's busy share of
the profiled window, the 25 kernels with the most CUDA time and the 30
slowest modules of one request (CUDA events recorded by forward hooks).
"""

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.models.packnet import SLIM_CHANNELS
from mindtheedge_tpu_torch.ops.blocks import (
    ConvBlock, Conv3dOverChannels, InvDepthHead, PackLayerConv3d,
    ResidualConv, UnpackLayerConv3d)
from mindtheedge_tpu_torch.ops.sparse import MinkConvBlock

B, H, W = 4, 384, 1280
REQUESTS = 2


def module_times(model, run):
    """Device ms of every ConvBlock, residual, pack/unpack, conv3d, SAN level
    and head during ``run()``, from CUDA events recorded by forward hooks."""
    kinds = (ConvBlock, ResidualConv, PackLayerConv3d, UnpackLayerConv3d,
             Conv3dOverChannels, MinkConvBlock, InvDepthHead)
    marks, handles = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, kinds):
            def pre(module, args, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append([name, ev, None])

            def post(module, args, out, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                next(m for m in reversed(marks)
                     if m[0] == name and m[2] is None)[2] = ev
            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post)]
    run()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    return [(name, a.elapsed_time(b)) for name, a, b in marks]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cudnn-heuristics', action='store_true',
                    help="let cuDNN's heuristics pick the conv algorithms "
                         "instead of the autotuner that serve.build turns on")
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    model = serve.build(SLIM_CHANNELS, device=dev, seed=0)
    torch.backends.cudnn.benchmark = not args.cudnn_heuristics
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8))
    lidar = rng.rand(B, H, W, 1).astype(np.float32) * 80.0
    lidar[rng.rand(B, H, W, 1) < 0.95] = 0.0
    lidar = torch.from_numpy(lidar)

    t0 = time.perf_counter()
    serve.serve(model, rgb, lidar)
    torch.cuda.synchronize()
    print(f'warm-up request: {(time.perf_counter() - t0) * 1e3:.3f} ms')

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        for i in range(REQUESTS):
            serve.serve(model, rgb + i, lidar * (1 + 1e-3 * i))   # uint8 wraps
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = start.elapsed_time(end) / REQUESTS
    print(f'batch {B}: {device_ms:.3f} ms per request (CUDA events), '
          f'{B * 1e3 / device_ms:.2f} img/s, cudnn.benchmark '
          f'{torch.backends.cudnn.benchmark}')

    events = prof.key_averages()
    kernel_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f'device busy {kernel_us / 1e3:.3f} ms of {wall_ms:.3f} ms wall '
          f'({100 * kernel_us / 1e3 / wall_ms:.1f} %)')
    print(events.table(sort_by='self_cuda_time_total', row_limit=25,
                       max_name_column_width=90))
    times = module_times(model, lambda: serve.serve(model, rgb, lidar))
    print('per module, one request (device ms, CUDA events; nested modules '
          'count in their parents too):')
    for name, ms in sorted(times, key=lambda t: -t[1])[:30]:
        print(f'  {name:40s} {ms:10.3f}')


if __name__ == '__main__':
    main()
