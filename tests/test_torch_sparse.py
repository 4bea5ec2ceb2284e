"""Port SAN ladder (mindtheedge_tpu_torch/ops/sparse.py) against the JAX one
(mindtheedge_tpu/ops/sparse.py): the masked pool exactly, the whole
SparseDepthEncoder with non-trivial batch statistics at rtol 1e-4,
atol 1e-5 (fp32; conv taps summed in different orders)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.ops import sparse as jsparse
from mindtheedge_tpu_torch.ops import sparse
from mindtheedge_tpu_torch.utils import weights
from tests.test_torch_blocks import nchw, nhwc, perturb

torch.set_num_threads(1)


@pytest.mark.parametrize('shape', [(2, 16, 24, 8), (2, 15, 23, 8)],
                         ids=['even', 'odd'])
def test_masked_pool_exact(shape):
    """Even shapes take the JAX phase-split path, odd ones its slice chain;
    active values are >= 0 everywhere the ladder pools."""
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32)
    mask = (rng.rand(*shape[:3], 1) < 0.2).astype(np.float32)
    want_x, want_m = jax.jit(jsparse.masked_max_pool_3x3_s2)(
        jnp.asarray(x), jnp.asarray(mask))
    got_x, got_m = sparse.masked_max_pool_3x3_s2(nchw(x), nchw(mask))
    np.testing.assert_array_equal(nhwc(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(nhwc(got_x), np.asarray(want_x))


def test_sparse_depth_encoder_matches_jax():
    channels = (16, 32, 16, 32, 16)
    rng = np.random.RandomState(1)
    depth = rng.rand(2, 64, 96, 1).astype(np.float32) * 80.0
    depth[rng.rand(2, 64, 96, 1) < 0.95] = 0.0
    jmod = jsparse.SparseDepthEncoder(channels=channels)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(depth))
    variables = perturb(jax.tree_util.tree_map(np.asarray, variables), rng)
    want = jax.jit(jmod.apply)(variables, jnp.asarray(depth))

    sd = {}
    weights.sparse_encoder(sd, 'm', variables['params'],
                           variables['batch_stats'])
    tmod = sparse.SparseDepthEncoder(channels)
    tmod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tmod.eval()(nchw(depth))
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f'level {lvl}')
