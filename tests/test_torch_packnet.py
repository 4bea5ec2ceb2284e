"""Port PackNet-SAN 1A eval forward against the JAX PackNetSAN, and the weight
converter against the JAX package's torch porter.

64x96, channels (16,)*6, batch 2, all 4 scales, with LiDAR and without.
Tolerance rtol 1e-3, atol 1e-4: the tolerance of
tests/test_full_network_parity.py, fp32 through ~40 conv layers whose taps
the two sides sum in different orders.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.models.packnet import PackNetSAN as JaxPackNetSAN
from mindtheedge_tpu.utils.torch_port import port_packnet_san
from mindtheedge_tpu_torch.models.packnet import PackNetSAN
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_blocks import perturb

torch.set_num_threads(1)

CHANNELS = (16,) * 6
H, W = 64, 96


@pytest.fixture(scope='module')
def nets():
    rng = np.random.RandomState(0)
    rgb = rng.rand(2, H, W, 3).astype(np.float32)
    lidar = rng.rand(2, H, W, 1).astype(np.float32) * 80.0
    lidar[rng.rand(2, H, W, 1) < 0.95] = 0.0
    jmodel = JaxPackNetSAN(version='1A', channels=CHANNELS)
    variables = jax.jit(lambda k, r, d: jmodel.init(k, r, d, train=False))(
        jax.random.PRNGKey(0), rgb, lidar)
    variables = perturb(jax.tree_util.tree_map(np.asarray, variables), rng)
    model = PackNetSAN(CHANNELS).eval()
    model.load_state_dict(state_dict_from_jax(
        variables['params'], variables['batch_stats']), strict=True)
    return dict(jmodel=jmodel, variables=variables, model=model,
                rgb=rgb, lidar=lidar)


@pytest.mark.parametrize('with_lidar', [True, False], ids=['lidar', 'rgb'])
def test_packnet_san_matches_jax(nets, with_lidar):
    jmodel, variables = nets['jmodel'], nets['variables']
    rgb, lidar = nets['rgb'], nets['lidar'] if with_lidar else None
    want = jax.jit(lambda v, r, d: jmodel.apply(v, r, d, train=False))(
        variables, rgb, lidar)['inv_depths']
    with torch.no_grad():
        got = nets['model'](torch.from_numpy(rgb),
                            None if lidar is None else torch.from_numpy(lidar)
                            )['inv_depths']
    assert len(got) == len(want) == 4
    for scale, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (2, H >> scale, W >> scale, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-4, err_msg=f'scale {scale}')


def test_state_dict_roundtrips_through_jax_porter(nets):
    """state_dict_from_jax, then the JAX package's porter, gives back the
    JAX params and batch_stats bit for bit: the port's keys are the
    reference PackNetSAN01 names."""
    params, stats = nets['variables']['params'], nets['variables']['batch_stats']
    zero = jax.tree_util.tree_map(np.zeros_like, copy.deepcopy(
        {'params': params, 'batch_stats': stats}))
    sd = state_dict_from_jax(params, stats)
    ported, ported_stats, _ = port_packnet_san(
        sd, zero['params'], zero['batch_stats'])
    for want, got in ((params, ported), (stats, ported_stats)):
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        g_leaves, g_def = jax.tree_util.tree_flatten(got)
        assert w_def == g_def
        for a, b in zip(w_leaves, g_leaves):
            np.testing.assert_array_equal(np.asarray(b), a)
    assert set(sd) == set(nets['model'].state_dict())
