"""``ops/canny.canny_sweep`` on the card against the CPU, and the check
``chip_smoke.py`` phase 14 runs at KITTI's size.

This file imports neither JAX nor the JAX package (the CPU tests against
the JAX op are in ``tests/test_torch_canny.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_canny_cuda.py

The images are seeded uint8-range noisy blocky scenes
(``tests/test_torch_spatial_cuda.blocky_frames``); the sweep is the
edge-AUC protocol's 12 thresholds.  The maps must agree on >= 99.99 % of
pixels: the Sobel sums of integer images are exact on both sides, but
``atan2`` may round a bucket boundary the other way by an ulp, as the NMS
kernel's buckets may.
"""

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.ops import canny
from tests.test_torch_spatial_cuda import blocky_frames

SWEEP = tuple(range(20, 241, 20))
AGREE = 0.9999


def scenes(shape, seed=0):
    """[B,H,W] uint8-range float32 images."""
    b, h, w = shape
    return torch.from_numpy((blocky_frames(np.random.RandomState(seed), b, h, w)[..., 0]
                             * 255.0).round().astype(np.float32))


def canny_card_vs_cpu(dev, shape, thresholds=SWEEP, iters=3):
    """``canny_sweep`` of :func:`scenes` on ``dev`` and on the CPU ->
    {'agree': share of equal pixels, 'steps', 'checks' (the card's
    dilation steps and host reads), 'ms' (one sweep on the card by CUDA
    events, the mean of ``iters`` after a warm-up), 'edges' (edge pixels
    a threshold on the card)}; asserts the agreement."""
    img = scenes(shape)
    t = torch.tensor(thresholds, dtype=torch.float32)
    want = canny.canny_sweep(img, thresholds)
    x = img.to(dev)
    got, steps, checks = canny.canny_counted(x, t / 2.0, t)
    assert got.device.type == dev.type and got.shape == (len(thresholds),) + tuple(shape)
    agree = float((got.cpu() == want).double().mean())
    assert agree >= AGREE, f'{agree:.6f} of pixels agree card vs CPU'
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    events[0].record()
    for _ in range(iters):
        canny.canny_sweep(x, thresholds)
    events[1].record()
    events[1].synchronize()
    return {'agree': agree, 'steps': steps, 'checks': checks,
            'ms': events[0].elapsed_time(events[1]) / iters,
            'edges': [int(n) for n in got.reshape(len(thresholds), -1).sum(1).tolist()]}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_canny_sweep_on_card_matches_cpu(cuda_card):
    out = canny_card_vs_cpu(cuda_card, (2, 96, 128), iters=1)
    assert out['edges'][0] > 0 and out['steps'] >= 1
