"""The CUDA Sobel-5 + NMS kernel (mindtheedge_tpu_torch/csrc/nms_kernel.cu)
against its plain version on the card, and the inputs both NMS test files use.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_nms_kernel.py

Without a CUDA device the card tests skip.
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


def misaligned(x):
    """A contiguous copy of ``x`` whose data pointer is 4 bytes past a
    16-byte boundary, so that the kernel cannot use 16-byte accesses."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def agree_with_plain_version(x):
    """Run the kernel on the card tensor ``x`` once and hold it against the
    plain version: kept values bit-equal; returns the share of equal pixels."""
    before = nms_kernel.launches
    got = nms_kernel.non_max_suppression(x)
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 1
    want = edge_ops.non_max_suppression(x)
    both = (got > 0) & (want > 0)
    assert torch.equal(got[both], want[both])
    return (got == want).float().mean().item()


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
        share = agree_with_plain_version(x)
        if img.shape == (9, 9):
            assert share == 1.0
        assert share >= 0.9999


CARD_SHAPES = [
    (4, 384, 1280),               # the serving map
    (2, 192, 640), (2, 96, 320), (2, 48, 160),    # DEE annotation scales
    (3, 37, 53), (2, 70, 130),    # W % 4 != 0
    (1, 5, 7), (4, 3, 3),         # H below one band of the kernel
    (2, 11, 4), (1, 9, 124),      # reflect-101 columns inside a float4 row
    (4, 383, 1280), (2, 401, 1283),   # 4-row bands, the last one ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', CARD_SHAPES,
                         ids=['x'.join(map(str, s)) for s in CARD_SHAPES])
def test_kernel_shapes_on_card(cuda_card, shape):
    img = np.random.RandomState(6).rand(*shape).astype(np.float32)
    x = torch.from_numpy(img).to(cuda_card)
    assert agree_with_plain_version(x) >= 0.9999


@pytest.mark.cuda
def test_kernel_smoothed_serving_map_on_card(cuda_card):
    rng = np.random.RandomState(7)
    img = np.stack([gaussian_blur(rng.rand(384, 1280).astype(np.float32)) * 4.0
                    for _ in range(4)])
    x = torch.from_numpy(img).to(cuda_card)
    assert agree_with_plain_version(x) >= 0.9999


@pytest.mark.cuda
def test_kernel_dyadic_patch_exact_on_card(cuda_card):
    x = torch.from_numpy(dyadic_patch()).to(cuda_card)
    assert agree_with_plain_version(x) == 1.0
    assert nms_kernel.non_max_suppression(x)[4, 4].item() == 0.5


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 48, 160), (4, 384, 1280)])
def test_kernel_misaligned_input_on_card(cuda_card, shape):
    img = np.random.RandomState(8).rand(*shape).astype(np.float32)
    x = misaligned(torch.from_numpy(img).to(cuda_card))
    assert x.data_ptr() % 16 == 4 and x.is_contiguous()
    assert agree_with_plain_version(x) >= 0.9999


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_on_card(cuda_card):
    x = torch.rand(2, 64, 96, device=cuda_card).transpose(1, 2)
    before = nms_kernel.launches
    with pytest.raises(ValueError, match='contiguous'):
        nms_kernel.non_max_suppression(x)
    assert nms_kernel.launches == before
