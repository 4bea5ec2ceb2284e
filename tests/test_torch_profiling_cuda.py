"""The program's spans on the card: in traced bf16 requests at full size
(PackNet-SAN 1A, SLIM widths, batch 4 at 384x1280), the kernels that the
profiler's device timeline shows inside the ``mte.net.conv3d`` annotations
sum to within 10 % of the spans' CUDA-event reading (the reading of
``conv3d_ms.infer``): the two clocks agree.  The same holds at batch 16
with the device behind the host (inputs on the card, a sleep kernel ahead
of the requests), where neither clock can see the host.  ``h2d_bytes``
counts the host inputs' bytes as uploaded (the LiDAR cast to bf16 first)
and 0 for inputs already on the card.

Known to fail on the card since the pack layers' convs became one kernel
of ~0.11 ms a span at batch 4: the served-size check reads the events
27-44 % above the kernels (1.412 and 1.627 against 1.110 and 1.130 ms a
request in two runs, NVIDIA H100 80GB HBM3), because the device waits
inside each span for the host's launch, which the events count and the
kernels do not (ROADMAP item 44).

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling_cuda.py
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.utils import profiling

B, H, W = 4, 384, 1280
TIMED_B = 16                # the batch of the requests behind a sleep
REQUESTS = 3
AGREE = 0.10
LEAD_CYCLES = 600_000_000   # the sleep kernel ahead of the timed requests, ~0.3 s


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def request_inputs(seed=0, b=B):
    gen = torch.Generator().manual_seed(seed)
    rgb_u8 = torch.randint(0, 256, (b, H, W, 3), generator=gen, dtype=torch.uint8)
    lidar = torch.rand(b, H, W, 1, generator=gen) * 80.0
    lidar[torch.rand(b, H, W, 1, generator=gen) < 0.95] = 0.0
    return rgb_u8.pin_memory(), lidar.pin_memory()


def conv3d_clocks(model, rgb_u8, lidar, lead_cycles=0, requests=REQUESTS):
    """``requests`` traced requests, behind a sleep kernel of ``lead_cycles``
    where that is set -> (the ``mte.net.conv3d`` spans' CUDA-event
    ms a request, the ms a request of the kernels inside the spans'
    annotations on the profiler's device timeline, the annotations seen,
    the requests' records)."""
    for _ in range(2):              # cuDNN's autotuning, then a warm request
        serve.serve(model, rgb_u8, lidar)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
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
        assert r['counters'] == {'h2d_bytes': rgb_u8.nbytes + lidar.nbytes // 2,
                                 'conv3d_kernel': 10, 'gn_elu_kernel': 47}


@pytest.mark.cuda
def test_conv3d_clocks_agree_bf16_device_behind(cuda_card):
    model = serve.build(device=cuda_card, seed=0, dtype=torch.bfloat16)
    rgb, lidar = (t.to(cuda_card) for t in request_inputs(b=TIMED_B))
    event_ms, kernel_ms, seen, recs = conv3d_clocks(model, rgb, lidar, LEAD_CYCLES)
    print(f'conv3d a batch-{TIMED_B} request behind a sleep: CUDA events {event_ms:.3f} ms, '
          f'profiler kernels {kernel_ms:.3f} ms ({seen} annotations)')
    assert len(recs) == REQUESTS and seen == 10 * REQUESTS
    assert kernel_ms > 0 and abs(event_ms - kernel_ms) <= AGREE * kernel_ms
    for r in recs:
        assert r['counters'] == {'h2d_bytes': 0, 'conv3d_kernel': 10, 'gn_elu_kernel': 47}


@pytest.mark.cuda
def test_h2d_bytes_zero_for_inputs_on_the_card(cuda_card):
    model = serve.build((16,) * 6, device=cuda_card, seed=0)
    rgb_u8, lidar = (t[:, :64, :96].to(cuda_card) for t in request_inputs())
    profiling.reset()
    with profiling.recording():
        serve.serve(model, rgb_u8, lidar)
    (rec,) = profiling.records()
    assert rec['counters'] == {'h2d_bytes': 0, 'conv3d_kernel': 10}
    assert all(s['device_ms'] >= 0 for s in rec['spans'])
