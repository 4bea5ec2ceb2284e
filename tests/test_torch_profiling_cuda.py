"""The program's spans on the card: in traced bf16 requests at full size
(PackNet-SAN 1A, SLIM widths, batch 4 at 384x1280), the kernels that the
profiler's device timeline shows inside the ``mte.net.conv3d`` annotations
sum to within 10 % of the spans' CUDA-event reading (the reading of
``conv3d_ms.infer``): the two clocks agree.  ``h2d_bytes`` counts the
host inputs' bytes as uploaded (the LiDAR cast to bf16 first) and 0 for
inputs already on the card.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling_cuda.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.utils import profiling

B, H, W = 4, 384, 1280
REQUESTS = 3
AGREE = 0.10


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def request_inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    rgb_u8 = torch.randint(0, 256, (B, H, W, 3), generator=gen, dtype=torch.uint8)
    lidar = torch.rand(B, H, W, 1, generator=gen) * 80.0
    lidar[torch.rand(B, H, W, 1, generator=gen) < 0.95] = 0.0
    return rgb_u8.pin_memory(), lidar.pin_memory()


def conv3d_clocks(model, rgb_u8, lidar, requests=REQUESTS):
    """``requests`` traced requests -> (the ``mte.net.conv3d`` spans' CUDA-event
    ms a request, the ms a request of the kernels inside the spans'
    annotations on the profiler's device timeline, the annotations seen,
    the requests' records)."""
    for _ in range(2):              # cuDNN's autotuning, then a warm request
        serve.serve(model, rgb_u8, lidar)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(requests):
            serve.serve(model, rgb_u8, lidar)
        torch.cuda.synchronize()
    recs = profiling.records()
    event_ms = sum(s['device_ms'] for r in recs for s in r['spans']
                   if s['name'] == 'mte.net.conv3d') / requests
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name() for e in events if e.device_type() != cuda}
    device = [e for e in events if e.device_type() == cuda and e.duration_ns() > 0]
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device
             if e.name() == 'mte.net.conv3d']
    inside = 0
    for e in device:
        if e.name() in host:
            continue
        mid = e.start_ns() + e.duration_ns() // 2
        if any(s <= mid <= t for s, t in spans):
            inside += e.duration_ns()
    return event_ms, inside / 1e6 / requests, len(spans), recs


@pytest.mark.cuda
def test_conv3d_clocks_agree_bf16(cuda_card):
    model = serve.build(device=cuda_card, seed=0, dtype=torch.bfloat16)
    rgb_u8, lidar = request_inputs()
    event_ms, kernel_ms, seen, recs = conv3d_clocks(model, rgb_u8, lidar)
    print(f'conv3d a request: CUDA events {event_ms:.3f} ms, '
          f'profiler kernels {kernel_ms:.3f} ms ({seen} annotations)')
    assert len(recs) == REQUESTS and seen == 10 * REQUESTS
    assert kernel_ms > 0 and abs(event_ms - kernel_ms) <= AGREE * kernel_ms
    for r in recs:
        assert r['counters'] == {'h2d_bytes': rgb_u8.nbytes + lidar.nbytes // 2}


@pytest.mark.cuda
def test_h2d_bytes_zero_for_inputs_on_the_card(cuda_card):
    model = serve.build((16,) * 6, device=cuda_card, seed=0)
    rgb_u8, lidar = (t[:, :64, :96].to(cuda_card) for t in request_inputs())
    profiling.reset()
    with profiling.recording():
        serve.serve(model, rgb_u8, lidar)
    (rec,) = profiling.records()
    assert rec['counters'] == {'h2d_bytes': 0}
    assert all(s['device_ms'] >= 0 for s in rec['spans'])
