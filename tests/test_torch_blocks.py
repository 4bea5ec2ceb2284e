"""Port blocks (mindtheedge_tpu_torch/ops/blocks.py, plain formulation) against
the JAX blocks (mindtheedge_tpu/ops/blocks.py, which take their TPU-layout
branches: W-lane packing, the composed pack-layer kernel).

Inputs and perturbed weights are made with numpy from a seed; weights cross
over through ``utils/weights``.  Tolerance rtol 1e-4, atol 1e-5: fp32, the
two sides sum conv taps and GroupNorm moments in different orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.ops import blocks as jblocks
from mindtheedge_tpu_torch.ops import blocks
from mindtheedge_tpu_torch.utils import weights

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def perturb(tree, rng):
    """Non-trivial values for the leaves that init leaves at constants:
    biases, norm scales, fusion weights and batch statistics."""
    if isinstance(tree, dict):
        return {k: (perturb(v, rng) if isinstance(v, dict)
                    else _leaf(k, np.asarray(v), rng)) for k, v in tree.items()}
    return tree


def _leaf(name, a, rng):
    draw = {'bias': (-0.2, 0.2), 'mean': (-0.2, 0.2),
            'scale': (0.5, 1.5), 'weight': (0.5, 1.5), 'var': (0.5, 2.0)}
    if name not in draw:
        return a
    return rng.uniform(*draw[name], a.shape).astype(np.float32)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _prefixed(fn, p):
    sd = {}
    fn(sd, 'm', p)
    return {k[2:]: v for k, v in sd.items()}


# name: (JAX module, port module, input NHWC shape, params -> state_dict)
CASES = {
    'GroupNorm': (jblocks.GroupNorm(num_groups=16), blocks.GroupNorm(32),
                  (2, 16, 24, 32), lambda p: _prefixed(weights.group_norm, p)),
    'ConvBlock_k3': (jblocks.ConvBlock(32, 3), blocks.ConvBlock(16, 32, 3),
                     (2, 16, 24, 16), lambda p: _prefixed(weights.conv_block, p)),
    'ConvBlock_k7': (jblocks.ConvBlock(16, 7), blocks.ConvBlock(8, 16, 7),
                     (2, 16, 24, 8), lambda p: _prefixed(weights.conv_block, p)),
    'ConvBlock_s2': (jblocks.ConvBlock(32, 3, stride=2),
                     blocks.ConvBlock(16, 32, 3, stride=2),
                     (2, 16, 24, 16), lambda p: _prefixed(weights.conv_block, p)),
    'ResidualBlock': (jblocks.ResidualBlock(32, 2),
                      blocks.ResidualBlock(16, 32, 2), (2, 16, 24, 16),
                      lambda p: _prefixed(weights.residual_block, p)),
    'InvDepthHead': (jblocks.InvDepthHead(1), blocks.InvDepthHead(16, 1),
                     (2, 16, 24, 16),
                     lambda p: {f'conv1.{k}': v for k, v in
                                _prefixed(weights.conv, p['conv1']).items()}),
    'PackLayerConv3d': (jblocks.PackLayerConv3d(16, 3, d=4),
                        blocks.PackLayerConv3d(16, 3, d=4), (2, 16, 24, 16),
                        lambda p: _prefixed(weights.pack_layer, p)),
    'UnpackLayerConv3d': (jblocks.UnpackLayerConv3d(16, 3, d=4),
                          blocks.UnpackLayerConv3d(32, 16, 3, d=4),
                          (2, 8, 12, 32),
                          lambda p: _prefixed(weights.pack_layer, p)),
}


@pytest.mark.parametrize('name', list(CASES))
def test_block_matches_jax(name):
    jmod, tmod, shape, to_state = CASES[name]
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x))['params']
    params = perturb(jax.tree_util.tree_map(np.asarray, params), rng)
    want = np.asarray(jax.jit(jmod.apply)({'params': params}, jnp.asarray(x)))

    tmod.load_state_dict(to_state(params), strict=True)
    with torch.no_grad():
        got = nhwc(tmod.eval()(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
