"""The spatially sharded training step with the 4-channel ``rgb_edge``
input, on the CPU against the JAX package's plain step: the paper's
``SemiSupEdgeModel`` on PackNet-SAN 1A with ``input_channels`` 4 (channels
(16,)*6, LiDAR, dropout 0, flip 0, the JAX weights carried over), global
batch [2,128,64], 2 ranks over gloo, H over 2
(``tests/test_torch_spatial_cuda.train_job``).

``make_spatial_train_step``'s ``net_input_transform`` slices ``rgb_edge``
to the rank's rows for the network, while the edge loss reads the whole
map as its ``seg_mask``, as the JAX step's ``slice_local_h`` leaves it
(``mindtheedge_tpu/parallel/spatial.py:264-275``); the edge loss runs at
scale 0, where the mask fits.  Tolerances are
``tests/test_torch_spatial_train.py``'s: the loss rtol 1e-5, every
gradient rtol 1e-3 / atol 1e-4 and within 3e-4 of its tensor's largest,
``grad_norm`` rtol 1e-3, the SAN's running statistics rtol 1e-4; both
ranks hold the same gradients.
"""

import numpy as np
import jax
import pytest
import torch

from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_blocks import perturb
from tests.test_torch_dp_cuda import start_ranks
from tests.test_torch_spatial_cuda import train_job
from tests.test_torch_spatial_train import (
    check_stats, check_step, grads_as_port, jax_grads, save_batch)
from tests.test_torch_train_cuda import synthetic_batch
from tests.test_torch_train_step import port_config, train_config

torch.set_num_threads(1)

B, H, W = 2, 128, 64


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The ranks' step, started first; meanwhile JAX's."""
    tmp = tmp_path_factory.mktemp('spatial_rgb_edge')
    jcfg = train_config()
    jcfg.model.depth_net.input_channels = 4
    # the edge loss's seg_mask is rgb_edge at full size, so it runs at scale
    # 0 alone (at all 4 scales the JAX package's own step fails to broadcast
    # the mask against the smaller scales)
    jcfg.model.loss.edges_depth_edge_loss_all_scales = False
    rng = np.random.RandomState(0)
    batch = {k: v.numpy() for k, v in synthetic_batch(rng, B, H, W).items()}
    batch['rgb_edge'] = rng.uniform(0.2, 1.0, (B, H, W, 1)).astype(np.float32)
    jtask = jtasks.build_task(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init)(
        jax.random.PRNGKey(0), {k: v[:1] for k, v in batch.items()}))
    depth = {'params': perturb(variables['depth']['params'], np.random.RandomState(1)),
             'batch_stats': variables['depth']['batch_stats']}
    port_config(jcfg).save_yaml(str(tmp / 'edge4.yaml'))
    torch.save(state_dict_from_jax(depth['params'], depth['batch_stats']), tmp / 'edge4.pt')
    save_batch(batch, tmp / 'edge4.npz')
    ranks = start_ranks([(train_job, {'config': str(tmp / 'edge4.yaml'),
                                      'batch': str(tmp / 'edge4.npz'), 'grid': (2,),
                                      'depth_weights': str(tmp / 'edge4.pt')})],
                        2, str(tmp / 'pair'))
    try:
        want = jax_grads(jcfg, {'depth': depth}, batch)
    finally:
        ranks.join()
    return ranks, want, depth


def test_rgb_edge_space_step_matches_jax(runs):
    ranks, (loss, metrics, grads, stats), depth = runs
    results = ranks.result(0)
    check_step(results, loss, metrics, grads_as_port(grads))
    check_stats(results[0]['state'], depth['params'], stats)
    assert float(results[0]['grads']['depth.encoder.pre_calc.conv_base.weight'][:, 3]
                 .abs().max()) > 0
