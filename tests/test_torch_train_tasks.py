"""The training tasks this port added after the paper's ``SemiSupEdgeModel``
against the JAX package's, one ``train_loss`` + backward each: DEE training
(``EdgeEstimationLIDARModel``, with LiDAR at 4 edge scales and without at
scale 0) and the two completion tasks, on PackNet-SAN 1A at 64x96, channels
(16,)*6, batch 2.  The self-supervised family is in
tests/test_torch_train_selfsup.py, which shares these helpers.

The JAX weights are carried over by ``utils/weights``; random draws cannot
match JAX's, so dropout is 0 and ``flip_lr_prob`` 0.  Tolerances are
tests/test_torch_train_step.py's: the loss and each metric rtol 1e-4; each
parameter's gradient within 3e-4 of that tensor's largest |gradient|, and
a tensor whose gradient vanishes analytically (largest |gradient| below
1e-5 of the network's) within 1e-5 of the network's largest; running
statistics rtol 1e-4.  One floor is added: a gradient within 1e-6 of its
network's largest passes (:func:`assert_grads_close`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu_torch import config
from mindtheedge_tpu_torch.models import tasks
from mindtheedge_tpu_torch.training.train_step import create_train_state
from mindtheedge_tpu_torch.utils.weights import (
    pose_state_dict_from_jax, resnet_state_dict_from_jax, state_dict_from_jax)
from tests.test_torch_blocks import perturb
from tests.test_torch_geometry import intrinsics
from tests.test_torch_train_cuda import smooth_images
from tests.test_torch_train_step import make_batch, B, H, W

torch.set_num_threads(1)

CHANNELS = (16,) * 6
LR, POSE_LR = 1e-3, 5e-4
GRAD_RTOL = 3e-4
NOISE_FLOOR = 1e-6      # of the network's largest |gradient|, see assert_grads_close


def task_config(name, weight=1.0, depth_net='PackNetSAN01', pose_net='', **loss):
    """The JAX package's config of a training task, deterministic."""
    cfg = jconfig.get_cfg_defaults()
    cfg.model.name = name
    cfg.model.depth_net.name = depth_net
    cfg.model.depth_net.version = '1A' if depth_net == 'PackNetSAN01' else ''
    cfg.model.depth_net.channels = CHANNELS
    cfg.model.depth_net.dropout = 0.0
    cfg.model.pose_net.name = pose_net
    cfg.model.loss.supervised_method = 'sparse-silog'
    cfg.model.loss.supervised_num_scales = 1
    cfg.model.loss.supervised_loss_weight = weight
    cfg.model.loss.edges_depth_edge_loss_all_scales = True
    cfg.model.loss.upsample_depth_maps = False
    cfg.model.loss.flip_lr_prob = 0.0
    cfg.model.loss.merge_from_other_cfg(loss)
    cfg.model.optimizer.depth.lr = LR
    cfg.model.optimizer.pose.lr = POSE_LR
    cfg.edges.train_depth_edges = True
    cfg.edges.depth_edges_loss_weight = 10.0
    return jconfig.prepare_config(cfg)


def port_config(jcfg):
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    return cfg


def selfsup_batch(seed):
    """``make_batch`` plus what the self-supervised losses read: two
    context images, the unaugmented target and contexts, KITTI-like
    intrinsics and the GT poses of the contexts.

    The networks' inputs (``rgb``, ``rgb_context``) are white noise, the
    photometric loss's images (``rgb_original``, ``rgb_context_original``)
    smooth texture (``smooth_images`` says why): on a smooth input the
    first GroupNorms' channels are nearly constant, and the JAX
    GroupNorm's one-pass variance loses most of its digits there (measured:
    the gradient of a conv bias before a one-channel group, analytically
    zero, then differed from JAX's by 1.9e-4)."""
    batch = make_batch(seed)
    rng = np.random.RandomState(seed + 100)
    batch['rgb_context'] = [rng.rand(B, H, W, 3).astype(np.float32) for _ in range(2)]
    batch['rgb_original'], *batch['rgb_context_original'] = smooth_images(rng, 3, B, H, W)
    batch['intrinsics'] = intrinsics(B, H, W)
    batch['pose_context'] = [np.tile(np.eye(4, dtype=np.float32), (B, 1, 1)) for _ in range(2)]
    for i, p in enumerate(batch['pose_context']):
        p[:, :3, 3] = rng.uniform(-0.5, 0.5, (B, 3))
    return batch


def to_torch(batch):
    return {k: [torch.from_numpy(np.array(x)) for x in v] if isinstance(v, list)
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def pose_head_bias(params, rng):
    """A pose head bias that moves pixels by a few pixels: translations
    ~0.2 m and rotations ~0.02 rad after the head's x0.01."""
    head = params['pose_pred'] if 'pose_pred' in params else params['decoder']['pose_2']
    n = head['bias'].shape[0] // 6
    head['bias'] = np.tile(np.concatenate([rng.uniform(-30, 30, 3), rng.uniform(-2, 2, 3)]),
                           n).astype(np.float32)
    return params


def depth_head_bias(params):
    """``DepthResNet``'s disparity heads biased to -4: its untrained
    disparity sigmoid(0) maps to 0.2 m, where a 0.3 m pose translation puts
    points behind the camera (Z clipped at 1e-5, coordinates ~1e4 and
    derivatives ~1/Z^2); sigmoid(-4) maps to ~5 m."""
    for key, p in params['decoder'].items():
        if key.startswith('dispconv'):
            p['conv']['bias'] = np.full_like(p['conv']['bias'], -4.0)
    return params


def jax_variables(jcfg, batch, seed=0):
    """Perturbed JAX variables of the task's networks, with the pose and
    ResNet depth heads of :func:`pose_head_bias` and :func:`depth_head_bias`."""
    jtask = jtasks.build_task(jcfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jtask.init)(jax.random.PRNGKey(seed), batch))
    rng = np.random.RandomState(seed + 1)
    out = {}
    for net, v in variables.items():
        v = dict(v, params=perturb(v['params'], rng))
        if net == 'pose':
            v['params'] = pose_head_bias(v['params'], rng)
        elif 'mconvs' not in v['params']:
            v['params'] = depth_head_bias(v['params'])
        out[net] = v
    return out


def depth_sd(tree, stats=None):
    return state_dict_from_jax(tree, stats) if 'mconvs' in tree \
        else resnet_state_dict_from_jax(tree, stats)


def port_task(jcfg, variables):
    task = tasks.build_task(port_config(jcfg), device='cpu')
    d = variables['depth']
    task.depth_net.load_state_dict(depth_sd(d['params'], d.get('batch_stats')), strict=True)
    assert (task.pose_net is None) == ('pose' not in variables)
    if task.pose_net is not None:
        p = variables['pose']
        task.pose_net.load_state_dict(
            pose_state_dict_from_jax(p['params'], p.get('batch_stats')), strict=True)
    return task


def assert_grads_close(task, want_grads):
    """Each gradient tensor within ``GRAD_RTOL`` of its largest |gradient|
    or within ``NOISE_FLOOR`` of its network's largest, whichever is more;
    one whose largest |gradient| is below 1e-5 of its network's vanishes
    analytically and is held within 1e-5 of that.

    The floor: a tensor whose gradient reaches the loss only through
    long cancelling sums is rounding noise below its own scale: DEE on
    scale 0 alone gives the scale-1 head's bias (which feeds the loss only
    through the decoder) a gradient that differs from JAX's by 7.2e-4 of
    its own largest, 1.6e-9 in absolute terms (measured)."""
    nets = [('depth', task.depth_net, depth_sd)]
    if task.pose_net is not None:
        nets.append(('pose', task.pose_net, pose_state_dict_from_jax))
    for net_name, net, convert in nets:
        got = {n: p.grad for n, p in net.named_parameters()}
        want = convert(want_grads[net_name])
        assert set(got) == set(want), net_name
        top = max(float(w.abs().max()) for w in want.values())
        for name, w in want.items():
            scale = float(w.abs().max())
            tol = 1e-5 * top if scale < 1e-5 * top else max(GRAD_RTOL * scale,
                                                             NOISE_FLOOR * top)
            g = torch.zeros_like(w) if got[name] is None else got[name]
            torch.testing.assert_close(g, w, rtol=0, atol=tol,
                                       msg=lambda m, n=f'{net_name}.{name}': f'{n}: {m}')


def assert_stats_close(task, params, new_stats):
    """The running statistics the step left against JAX's ``new_stats``."""
    want = depth_sd(params, new_stats)
    for name, t in task.depth_net.state_dict().items():
        if name.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(t, want[name], rtol=1e-4, atol=1e-6,
                                       msg=lambda m, name=name: f'{name}: {m}')


def check_train_loss(jcfg, batch, metric_keys):
    """One ``train_loss`` + backward of the port against
    ``jax.value_and_grad`` of the JAX task's: loss, metrics, gradients of
    both networks, and the running statistics the forward updates."""
    jtask = jtasks.build_task(jcfg)
    variables = jax_variables(jcfg, batch)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(params):
        v = {net: dict(variables[net], params=p) for net, p in params.items()}
        loss, (metrics, _, new_stats) = jtask.train_loss(v, jbatch, jax.random.PRNGKey(5))
        return loss, (metrics, new_stats)

    params = {net: v['params'] for net, v in variables.items()}
    (want, (want_metrics, new_stats)), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    task = port_task(jcfg, variables)
    loss, metrics = task.train_loss(to_torch(batch), torch.Generator().manual_seed(5))
    if loss.requires_grad:
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    assert set(metrics) == set(want_metrics) == set(metric_keys)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want_metrics[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert_grads_close(task, want_grads)
    if new_stats:
        assert_stats_close(task, params['depth'], new_stats)
    return task, metrics, variables


CASES = {
    'EdgeEstimationLIDARModel': {'edge_loss', 'edge_lidar_loss', 'depth_loss', 'loss'},
    'SemiSupCompletionModel': {'supervised_loss', 'supervised_loss_rgbd', 'depth_loss', 'loss'},
    'SemiSupEdgeCompletionModel': {'edge_loss', 'edge_lidar_loss', 'supervised_loss',
                                   'depth_loss', 'loss'},
}


@pytest.mark.parametrize('name', list(CASES))
def test_train_loss_matches_jax(name):
    """Both passes feed the loss: the RGBD pass's graph lives through the
    backward, and the SAN ladder gets gradients."""
    task, metrics, _ = check_train_loss(task_config(name), selfsup_batch(3), CASES[name])
    assert all(float(v) > 0 for v in metrics.values())
    assert float(task.depth_net.mconvs.mconvs[0].layer1[0].kernel.grad.abs().max()) > 0


def test_dee_without_lidar_and_scale_0_only_matches_jax():
    """DEE on the RGB pass alone, the edge loss on scale 0 only (the other
    scales not halved)."""
    jcfg = task_config('EdgeEstimationLIDARModel',
                       edges_depth_edge_loss_all_scales=False)
    batch = selfsup_batch(4)
    del batch['input_depth']
    check_train_loss(jcfg, batch, {'edge_loss', 'loss'})


@pytest.mark.parametrize('depth_net', ['PackNetSAN01', 'DepthResNet'])
def test_freeze_flags_leave_parameters_out(depth_net):
    """``freeze_encoder`` / ``freeze_san`` (with the fusion weights) leave
    those depth parameters out of the optimizer, whatever the network, as
    the JAX package's masks do (``optimizer.py:24-45``); the pose group
    keeps all of its own."""
    cfg = port_config(task_config('SemiSupModel', weight=0.5, depth_net=depth_net,
                                  pose_net='PoseNet'))
    cfg.model.depth_net.freeze_encoder = True
    cfg.model.depth_net.freeze_san = True
    task = tasks.build_task(cfg, device='cpu')
    state = create_train_state(cfg, task.depth_net, pose_net=task.pose_net)
    depth_group, pose_group = state.optimizer.param_groups
    names = {id(p): n for n, p in task.depth_net.named_parameters()}
    kept = {names[id(p)].split('.')[0] for p in depth_group['params']}
    assert kept == {'decoder'}
    assert len(pose_group['params']) == len(list(task.pose_net.parameters()))
