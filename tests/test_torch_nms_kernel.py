"""The CUDA Sobel-5 + NMS kernel (mindtheedge_tpu_torch/csrc/nms_kernel.cu)
against its plain version on the card, and the inputs both NMS test files use.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_nms_kernel.py

Without a CUDA device the card test skips.
"""

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.ops import edge_ops
from mindtheedge_tpu_torch.ops.cuda import nms_kernel


def gaussian_blur(img, ksize=31, sigma=8.0):
    """Separable Gaussian of [H,W] with a reflect-101 border (cv2's default)."""
    t = np.arange(ksize) - ksize // 2
    k = np.exp(-t ** 2 / (2 * sigma ** 2))
    k /= k.sum()
    p = ksize // 2
    h, w = img.shape
    x = np.pad(img.astype(np.float64), p, mode='reflect')
    x = sum(k[i] * x[i:i + h, :] for i in range(ksize))
    x = sum(k[i] * x[:, i:i + w] for i in range(ksize))
    return x.astype(np.float32)


def dyadic_patch():
    """Point-symmetric 9x9 patch of multiples of 1/8: the centre has
    sx = sy = 0 exactly.  Centre 0.5, row neighbours 0.25, anti-diagonal
    neighbours 0.875, so the horizontal pair keeps the centre and the
    135-degree pair would suppress it."""
    rng = np.random.RandomState(3)
    v = rng.randint(0, 9, (9, 9)).astype(np.float32) / 8.0
    p = np.where(np.arange(81).reshape(9, 9) > 40, v[::-1, ::-1], v)
    p[4, 4] = 0.5
    p[4, 3] = p[4, 5] = 0.25
    p[3, 5] = p[5, 3] = 0.875
    return p


def noise_inputs():
    """Uniform noise and Gaussian-smoothed noise x4 (tests/test_pallas_nms.py:50-59)."""
    rng = np.random.RandomState(2)
    noise = rng.rand(2, 128, 256).astype(np.float32)
    smooth = np.stack([gaussian_blur(n) * 4.0 for n in noise])
    return {'noise': noise, 'smooth': smooth}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc')
    return torch.device('cuda')


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_card):
    """The CUDA kernel against its plain version on the card: >= 99.99 % of
    pixels agree (slope tests vs atan2 at bucket boundaries), every pixel
    of the dyadic patch, and kept values are bit-equal."""
    imgs = list(noise_inputs().values()) + [
        dyadic_patch(), np.random.RandomState(5).rand(3, 37, 53)]
    for img in imgs:
        x = torch.from_numpy(np.asarray(img, np.float32)).to(cuda_card)
        before = nms_kernel.launches
        got = nms_kernel.non_max_suppression(x)
        torch.cuda.synchronize()
        assert nms_kernel.launches == before + 1
        want = edge_ops.non_max_suppression(x)
        same = got == want
        both = (got > 0) & (want > 0)
        assert torch.equal(got[both], want[both])
        if img.shape == (9, 9):
            assert bool(same.all())
        assert same.float().mean().item() >= 0.9999
