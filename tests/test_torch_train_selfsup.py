"""The self-supervised training tasks against the JAX package's, one step
each, with the helpers and tolerances of tests/test_torch_train_tasks.py:

* ``SemiSupModel`` at ``supervised_loss_weight`` 0.5 (without LiDAR) and
  ``SemiSupEdgeModel`` at 0.9 (with), on PackNet-SAN 1A (channels (16,)*6)
  with ``PoseNet``: the photometric loss at 4 scales over two context
  images beside the supervised (and edge) terms; the second as one full
  step with Adam over the depth and pose groups;
* ``SfmModel``, ``SelfSupModel`` and ``VelSupModel`` on ``DepthResNet``-18,
  the first two with ``PoseResNet``-18, the last with ``PoseNet``.

64x96, batch 2, the heads and batch of tests/test_torch_train_tasks.py
(poses and depths that move pixels by a few pixels; smooth images for the
photometric loss).  The pose network stays in eval mode in training, as in JAX (``PoseResNet``'s batch norms normalise with running
statistics that do not move); the depth ResNet's batch norms train and
their running statistics follow JAX's (momentum 0.9, biased variance).
"""

import numpy as np
import jax
import pytest
import torch

from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.training.optimizer import build_optimizer as jbuild_optimizer
from mindtheedge_tpu.training.train_step import create_train_state as jcreate_state
from mindtheedge_tpu.training.train_step import make_train_step as jmake_step
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from mindtheedge_tpu_torch.utils.weights import pose_state_dict_from_jax
from tests.test_torch_train_tasks import (
    GRAD_RTOL, LR, POSE_LR, check_train_loss, depth_sd, jax_variables, port_config,
    port_task, selfsup_batch, task_config, to_torch)

torch.set_num_threads(1)

PHOTOMETRIC = {'photometric_loss', 'smoothness_loss'}


def test_semisup_below_weight_1_matches_jax():
    """Without LiDAR: the RGB pass alone, against the JAX package in fp64
    (measured on the CPU: against JAX's fp32 gradients the port's worst
    tensor lay at 0.60 of its bound, within 2x of it)."""
    batch = selfsup_batch(3)
    del batch['input_depth']
    task, metrics, _ = check_train_loss(
        task_config('SemiSupModel', weight=0.5, pose_net='PoseNet'), batch,
        PHOTOMETRIC | {'supervised_loss', 'loss'}, x64=True)
    assert task.pose_net is not None and not task.pose_net.training
    assert float(task.pose_net.pose_pred.weight.grad.abs().max()) > 0


@pytest.mark.parametrize('name,pose_net,keys', [
    ('SfmModel', '', {'loss'}),
    ('SelfSupModel', 'PoseResNet', PHOTOMETRIC | {'loss'}),
    ('VelSupModel', 'PoseNet', PHOTOMETRIC | {'velocity_loss', 'loss'}),
])
def test_resnet_task_matches_jax(name, pose_net, keys):
    """``check_train_loss`` also holds DepthResNet's updated running
    statistics to JAX's; PoseResNet's stay where they were."""
    jcfg = task_config(name, depth_net='DepthResNet', pose_net=pose_net)
    task, metrics, variables = check_train_loss(jcfg, selfsup_batch(6), keys)
    if name == 'SfmModel':
        assert float(metrics['loss']) == 0.0
        assert all(p.grad is None for p in task.depth_net.parameters())
    if pose_net == 'PoseResNet':
        pose = variables['pose']
        start = pose_state_dict_from_jax(pose['params'], pose['batch_stats'])
        for k, v in task.pose_net.state_dict().items():
            if 'running' in k:
                assert torch.equal(v, start[k]), k


def test_one_adam_step_with_pose_group_matches_jax():
    """``SemiSupEdgeModel`` at w 0.9 with PoseNet, one full step against
    ``jax.jit(make_train_step(...))``: the metrics rtol 1e-4, ``grad_norm``
    over both networks rtol 1e-4, both networks' parameter deltas (the pose
    group at its own rate) within lr/128 outside the gradients' noise band
    and at most their group's lr, the SAN running statistics rtol 1e-4."""
    jcfg = task_config('SemiSupEdgeModel', weight=0.9, pose_net='PoseNet')
    jtask = jtasks.build_task(jcfg)
    batch = selfsup_batch(5)
    variables = jax_variables(jcfg, batch)
    params = {net: v['params'] for net, v in variables.items()}
    jopt = jbuild_optimizer(jcfg, params, steps_per_epoch=10)
    jbatch = jax.tree_util.tree_map(jax.numpy.asarray, batch)
    jstate = jcreate_state(jtask, jopt, jax.random.PRNGKey(0), jbatch, variables=variables)
    jnew, jmetrics = jax.jit(jmake_step(jtask, jopt))(jstate, jbatch, jax.random.PRNGKey(0))

    task = port_task(jcfg, variables)
    state = create_train_state(port_config(jcfg), task.depth_net, pose_net=task.pose_net)
    assert [g['lr'] for g in state.optimizer.param_groups] == [LR, POSE_LR]
    before = [{k: v.clone() for k, v in n.state_dict().items()} for n in state.networks()]
    metrics = make_train_step(task)(state, to_torch(batch), torch.Generator().manual_seed(0))
    assert state.step == int(jnew.step) == 1
    assert set(metrics) == set(jmetrics) == PHOTOMETRIC | {
        'edge_loss', 'supervised_loss', 'loss', 'grad_norm'}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    for net, old, key, convert, lr in (
            (task.depth_net, before[0], 'depth', depth_sd, LR),
            (task.pose_net, before[1], 'pose', pose_state_dict_from_jax, POSE_LR)):
        want_new = convert(jnew.params[key], jnew.batch_stats.get(key))
        want_old = convert(params[key])
        after = net.state_dict()
        grads = {n: p.grad for n, p in net.named_parameters()}
        top = max(float(g.abs().max()) for g in grads.values())
        for name, new in want_new.items():
            if name.endswith(('running_mean', 'running_var')):
                torch.testing.assert_close(after[name], new, rtol=1e-4, atol=1e-6, msg=name)
            if name not in grads:
                continue
            g = grads[name]
            noise = (torch.ones_like(g, dtype=torch.bool) if float(g.abs().max()) < 1e-5 * top
                     else g.abs() <= GRAD_RTOL * g.abs().max())
            delta = after[name] - old[name]
            off = (delta - (new - want_old[name])).abs()
            assert bool((off[~noise] <= lr / 128).all()), f'{key}.{name}'
            assert float(delta.abs().max()) <= lr * 1.001, f'{key}.{name}'
