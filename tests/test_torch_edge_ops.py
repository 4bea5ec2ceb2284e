"""The port's hysteresis, isolated-edge removal and normal map
(mindtheedge_tpu_torch/ops/edge_ops.py) against the JAX package's
(mindtheedge_tpu/ops/edge_ops.py).

Hysteresis and ``remove_isolated_edges`` compare and select exact values,
so they are held bit for bit.  The normal map is a floor of atan2 of Sobel
sums that the two sides round in different orders: codes may move by one,
and where both sums are ~0 (image corners, whose reflect-101 derivatives
vanish) the angle is noise, so >= 99.9 % of pixels must lie within circular
distance 1 (codes 0 and 255 are both the angle +-pi).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.ops import edge_ops as jedge
from mindtheedge_tpu_torch.ops import edge_ops
from tests.test_torch_annotate_cuda import normals_within_one_code
from tests.test_torch_nms_kernel import gaussian_blur

torch.set_num_threads(1)


def snake(h=20, w=64):
    """A weak boustrophedon chain with one strong seed at one end
    (tests/test_edge_ops.py:77-96)."""
    img = np.full((h, w), 0.01, np.float32)
    path = []
    for r in range(1, h - 1):
        cols = range(1, w - 1) if r % 2 else range(w - 2, 0, -1)
        path.extend((r, c) for c in cols)
    for r, c in path:
        img[r, c] = 0.5
    img[path[0]] = 0.9
    return img, path


def hysteresis_inputs():
    rng = np.random.RandomState(0)
    noise = rng.rand(2, 40, 56).astype(np.float32)
    smooth = np.stack([gaussian_blur(n, 9, 2.0) * 1.5 for n in rng.rand(2, 48, 64)])
    nms = np.array(jedge.non_max_suppression(jnp.asarray(smooth.astype(np.float32))))
    return {'noise': noise, 'nms': nms, 'snake': snake()[0]}


@pytest.mark.parametrize('name', ['noise', 'nms', 'snake'])
@pytest.mark.parametrize('check_every', [1, 4, 16])
def test_hysteresis_bit_equal(name, check_every):
    img = hysteresis_inputs()[name]
    want = np.asarray(jedge.hysteresis(jnp.asarray(img)))
    got, iterations, checks = edge_ops.hysteresis_counted(
        torch.from_numpy(img), check_every=check_every)
    np.testing.assert_array_equal(got.numpy(), want)
    assert checks == -(-iterations // check_every)
    assert got.numpy().any()


def test_hysteresis_long_snake_reaches_the_far_end():
    img, path = snake()
    got, iterations, _ = edge_ops.hysteresis_counted(torch.from_numpy(img))
    assert got[path[-1]] > 0 and 1 < iterations < img.size
    np.testing.assert_array_equal(edge_ops.hysteresis(torch.from_numpy(img)).numpy(),
                                  np.asarray(jedge.hysteresis(jnp.asarray(img))))


def test_hysteresis_max_iters_binds_like_jax():
    """With the backstop binding before the fixpoint, both stop after the
    same number of steps."""
    img = snake()[0]
    want = np.asarray(jedge.hysteresis(jnp.asarray(img), max_iters=5))
    got, iterations, _ = edge_ops.hysteresis_counted(
        torch.from_numpy(img), max_iters=5, check_every=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert iterations == 5
    assert not np.array_equal(want, np.asarray(jedge.hysteresis(jnp.asarray(img))))


def test_remove_isolated_edges_bit_equal():
    rng = np.random.RandomState(4)
    for img in ((rng.rand(30, 40) > 0.8).astype(np.float32),
                (rng.rand(2, 17, 23) > 0.6).astype(np.float32)):
        want = np.asarray(jedge.remove_isolated_edges(jnp.asarray(img)))
        got = edge_ops.remove_isolated_edges(torch.from_numpy(img))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('kind', ['noise', 'smooth'])
def test_normals_within_one_code(kind):
    rng = np.random.RandomState(5)
    img = rng.rand(2, 96, 160).astype(np.float32)
    if kind == 'smooth':
        img = np.stack([gaussian_blur(x, 15, 4.0) for x in img])
    want = np.asarray(jedge.normals_angle_255(jnp.asarray(img)))
    got = edge_ops.normals_angle_255(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape and got.min() >= 0 and got.max() <= 255
    assert normals_within_one_code(got, want, corners=True) >= 0.999


def test_decode_normal_png_matches():
    codes = np.arange(256, dtype=np.float32).reshape(16, 16)
    want = np.asarray(jedge.decode_normal_png(jnp.asarray(codes)))
    got = edge_ops.decode_normal_png(torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(edge_ops.decode_normal_png(codes.astype(np.float64)),
                                  jedge.decode_normal_png(codes.astype(np.float64)))
