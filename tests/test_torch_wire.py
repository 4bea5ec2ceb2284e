"""The port's sparse LiDAR uplink (mindtheedge_tpu_torch/ops/wire.py) against
the JAX package's (mindtheedge_tpu/ops/wire.py:67-103): the host encoding is
byte-identical, and the device scatter gives the same dense map, padding
slots dropped.  Exact: both quantise to 1/256 m and scatter the same
values."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.ops import wire as jwire
from mindtheedge_tpu_torch.ops import wire

torch.set_num_threads(1)


def sparse_lidar(rng, shape, density=0.05):
    d = rng.rand(*shape).astype(np.float32) * 80.0
    d[rng.rand(*shape) >= density] = 0.0
    return d


@pytest.mark.parametrize('shape,cap', [((24, 40), 128), ((24, 40, 1), 64),
                                       ((64, 96), 64 * 96 // 8)])
def test_sparse_lidar_matches_jax(shape, cap):
    dense = sparse_lidar(np.random.RandomState(2), shape)
    dense.reshape(-1)[0] = 5.0          # index 0 survives the padding
    idx, val = wire.encode_lidar_sparse(dense, cap)
    jidx, jval = jwire.encode_lidar_sparse(dense, cap)
    assert idx.dtype == np.uint32 and val.dtype == np.uint16
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(val, jval)
    h, w = shape[:2]
    assert (idx == h * w).any()          # padding slots present
    got = wire.decode_lidar_sparse(torch.from_numpy(idx.view(np.int32)),
                                   torch.from_numpy(val), h, w)
    want = np.asarray(jwire.decode_lidar_sparse(
        jnp.asarray(jidx), jnp.asarray(jval), h, w))
    assert got.shape == (1, h, w, 1) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sparse_lidar_batched_and_out_of_range_dropped():
    rng = np.random.RandomState(3)
    h, w, cap = 16, 24, 40
    dense = np.stack([sparse_lidar(rng, (h, w)) for _ in range(3)])
    pairs = [wire.encode_lidar_sparse(d, cap) for d in dense]
    idx = np.stack([p[0] for p in pairs]).astype(np.int64)
    val = np.stack([p[1] for p in pairs])
    idx[0, -1], val[0, -1] = h * w + 7, 1000     # beyond the padding index
    idx[1, -1], val[1, -1] = -3, 1000            # negative
    got = wire.decode_lidar_sparse(torch.from_numpy(idx), torch.from_numpy(val), h, w)
    want = np.asarray(jwire.decode_lidar_sparse(
        jnp.asarray(np.stack([p[0] for p in pairs])),
        jnp.asarray(np.stack([p[1] for p in pairs])), h, w))
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.round(dense * 256.0) / 256.0
    np.testing.assert_array_equal(got.numpy()[..., 0], ref.astype(np.float32))


def test_sparse_lidar_over_capacity_raises():
    with pytest.raises(ValueError, match='exceed wire capacity'):
        wire.encode_lidar_sparse(np.ones((4, 8), np.float32), 4)
