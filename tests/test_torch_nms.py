"""Sobel-5 + NMS: the port's plain version (mindtheedge_tpu_torch/ops/edge_ops.py)
against the JAX package's edge_ops, which is how the JAX package's own CPU
tests run its Pallas kernel (tests/test_pallas_nms.py:18-23); and the CUDA
kernel's wrapper on the CPU.  The kernel itself is tested on the card by
tests/test_torch_nms_kernel.py.

Tolerances: on noise, >= 99.9 % of pixels agree (the port sums the separable
Sobel taps in fp32 where JAX runs one HIGHEST-precision conv, so a pixel
near a direction-bucket boundary or a tie may flip).  On the exact-dyadic
patch every Sobel sum is exact, so the two agree on every pixel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.ops import edge_ops as jedge
from mindtheedge_tpu_torch.ops import edge_ops
from mindtheedge_tpu_torch.ops.cuda import nms_kernel
from tests.test_torch_nms_kernel import dyadic_patch, noise_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize('kind', ['noise', 'smooth'])
def test_sobel_matches_jax(kind):
    img = noise_inputs()[kind]
    for port, ref in ((edge_ops.sobel5_x, jedge.sobel5_x),
                      (edge_ops.sobel5_y, jedge.sobel5_y)):
        got = port(torch.from_numpy(img)).numpy()
        want = np.asarray(jax.jit(ref)(jnp.asarray(img)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('kind', ['noise', 'smooth'])
def test_plain_nms_matches_jax(kind):
    img = noise_inputs()[kind]
    got = edge_ops.non_max_suppression(torch.from_numpy(img)).numpy()
    want = np.asarray(jax.jit(jedge.non_max_suppression)(jnp.asarray(img)))
    agree = (got == want).mean()
    assert agree >= 0.999, f'{kind}: {agree:.6f} of pixels agree'
    assert (got > 0).mean() > 0.01        # NMS kept something


def test_plain_nms_dyadic_patch_exact():
    patch = dyadic_patch()
    t = torch.from_numpy(patch)
    assert edge_ops.sobel5_x(t)[4, 4] == 0 and edge_ops.sobel5_y(t)[4, 4] == 0
    got = edge_ops.non_max_suppression(t).numpy()
    want = np.asarray(jedge.non_max_suppression(jnp.asarray(patch)))
    np.testing.assert_array_equal(got, want)
    assert got[4, 4] == 0.5


@pytest.mark.parametrize('shape', [(37, 53), (3, 37, 53), (1, 5, 7), (3, 3),
                                   (2, 70, 130), (48, 160), (96, 320)])
def test_plain_nms_odd_shapes(shape):
    rng = np.random.RandomState(4)
    img = rng.rand(*shape).astype(np.float32)
    got = edge_ops.non_max_suppression(torch.from_numpy(img)).numpy()
    want = np.asarray(jedge.non_max_suppression(jnp.asarray(img)))
    assert got.shape == want.shape == shape
    assert (got == want).mean() >= 0.999


def test_wrapper_takes_plain_version_on_cpu():
    img = torch.from_numpy(noise_inputs()['noise'])
    before = nms_kernel.launches
    got = nms_kernel.non_max_suppression(img)
    assert nms_kernel.launches == before
    assert torch.equal(got, edge_ops.non_max_suppression(img))
