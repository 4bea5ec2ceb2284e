"""The port's training path (sparse BN and dropout in training, the PackNet-SAN
train contract, ``SemiSupEdgeTask.train_loss``, one Adam step, StepLR)
against the JAX package's, on the same numpy inputs with the JAX weights
carried over by ``utils/weights.state_dict_from_jax``.

64x96, channels (16,)*6, batch 2, LiDAR 95 % sparse, GT depth 90 % sparse,
edges and normals at the 4 scales.  Random draws cannot match JAX's, so the
parity runs at dropout 0 and ``flip_lr_prob`` 0 and 1, which are
deterministic in both.  Tolerances: network outputs rtol 1e-3 as the eval
parity (tests/test_torch_packnet.py); the loss and its metrics rtol 1e-4;
each parameter's gradient within 3e-4 of that tensor's largest |gradient|
(``assert_grads_close`` gives the measured spread, and what holds where
the gradient vanishes);
parameter deltas of one Adam step within lr/128, which covers the JAX
package's bfloat16 first moment (an update moves by at most about
lr * 2**-8 from it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.ops import sparse as jsparse
from mindtheedge_tpu.training.optimizer import build_optimizer as jbuild_optimizer
from mindtheedge_tpu.training.optimizer import steplr
from mindtheedge_tpu.training.train_step import create_train_state as jcreate_state
from mindtheedge_tpu.training.train_step import make_train_step as jmake_step
from mindtheedge_tpu_torch import config
from mindtheedge_tpu_torch.models import tasks
from mindtheedge_tpu_torch.ops import blocks, sparse
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from mindtheedge_tpu_torch.utils.weights import batch_norm, state_dict_from_jax
from tests.test_torch_blocks import nchw, nhwc, perturb

torch.set_num_threads(1)

CHANNELS = (16,) * 6
B, H, W = 2, 64, 96
LR = 1e-3


def train_config(flip_lr_prob=0.0, dropout=0.0):
    """The JAX package's config for the paper's training model."""
    cfg = jconfig.get_cfg_defaults()
    cfg.model.name = 'SemiSupEdgeModel'
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.version = '1A'
    cfg.model.depth_net.channels = CHANNELS
    cfg.model.depth_net.dropout = dropout
    cfg.model.loss.supervised_method = 'sparse-silog'
    cfg.model.loss.supervised_num_scales = 1
    cfg.model.loss.supervised_loss_weight = 1.0
    cfg.model.loss.edges_depth_edge_loss_all_scales = True
    cfg.model.loss.upsample_depth_maps = False
    cfg.model.loss.flip_lr_prob = flip_lr_prob
    cfg.model.optimizer.depth.lr = LR
    cfg.model.scheduler.step_size = 2
    cfg.edges.train_depth_edges = True
    cfg.edges.depth_edges_loss_weight = 10.0
    return jconfig.prepare_config(cfg)


def port_config(jcfg):
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    return cfg


def make_batch(seed=0):
    """A numpy training batch: blocky depth, its edges, normals as angles."""
    rng = np.random.RandomState(seed)
    depth = np.full((B, H, W, 1), 30.0, np.float32)
    for i in range(B):
        for _ in range(3):
            y, x = rng.randint(0, H // 2), rng.randint(0, W // 2)
            depth[i, y:y + rng.randint(8, H // 2), x:x + rng.randint(8, W // 2)] = \
                rng.uniform(5, 25)
    batch = {'rgb': rng.rand(B, H, W, 3).astype(np.float32)}
    gt = depth.copy()
    gt[rng.rand(B, H, W, 1) < 0.9] = 0.0
    batch['depth'] = gt
    lidar = depth.copy()
    lidar[rng.rand(B, H, W, 1) < 0.95] = 0.0
    batch['input_depth'] = lidar
    for s, key in enumerate(('', '_1', '_2', '_3')):
        d = depth[:, ::2 ** s, ::2 ** s]
        edge = (np.abs(np.diff(d, axis=2, append=d[:, :, -1:])) > 0) | \
            (np.abs(np.diff(d, axis=1, append=d[:, -1:])) > 0)
        batch['edge' + key] = edge.astype(np.float32)
        batch['normal' + key] = ((rng.rand(*d.shape) * 2 - 1) * np.pi).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def weights():
    """Perturbed JAX variables of the task's network (the SAN running
    statistics at their init values, as the JAX trainer starts)."""
    jtask = jtasks.build_task(train_config())
    variables = jax.jit(jtask.init)(jax.random.PRNGKey(0), make_batch())
    depth = jax.tree_util.tree_map(np.asarray, variables['depth'])
    return {'params': perturb(depth['params'], np.random.RandomState(1)),
            'batch_stats': depth['batch_stats']}


def port_task(jcfg, weights, device='cpu'):
    task = tasks.build_task(port_config(jcfg), device=device)
    task.depth_net.load_state_dict(
        state_dict_from_jax(weights['params'], weights['batch_stats']), strict=True)
    return task


def grads_by_name(net):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad)
            for n, p in net.named_parameters()}


GRAD_RTOL = 3e-4      # of each tensor's largest |gradient|


def vanishing(w, top):
    """Whether a JAX gradient tensor is rounding noise: its largest |value|
    below 1e-5 of the network's largest |gradient| ``top``."""
    return float(w.abs().max()) < 1e-5 * top


def assert_grads_close(got, want_tree):
    """Each tensor within ``GRAD_RTOL`` of its largest |gradient|.

    Measured on these inputs (batch seeds 3 and 4, flip 0 and 1): the port
    is within 2.9e-5 to 4.9e-5 of that scale in the median tensor and
    within 1.42e-4 in the worst, a GroupNorm scale or a conv3d bias.  The
    JAX GroupNorm takes its variance in one pass, E[x^2] - E[x]^2
    (``blocks.py:113-124``), torch's in two, so the two round differently
    through ~40 normalised layers; 1e-4 of the largest |gradient| lies
    inside that noise.

    Where a tensor's largest |gradient| is below 1e-5 of the network's, the
    gradient vanishes analytically and both sides hold rounding noise: with
    channels (16,)*6 the GroupNorm has one channel per group, so the bias of
    the conv in front of it gets an exact zero (and the SAN ladder, whose
    outputs no loss reads, gets zero).  Such a tensor is held within 1e-5
    of the network's largest |gradient| (measured: 3.2e-6).
    """
    want = state_dict_from_jax(want_tree)
    assert set(want) == set(got)
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        tol = 1e-5 * top if vanishing(w, top) else GRAD_RTOL * float(w.abs().max())
        torch.testing.assert_close(got[name], w, rtol=0, atol=tol,
                                   msg=lambda m, name=name: f'{name}: {m}')


def test_masked_batch_norm_train_matches_jax():
    """Active-site statistics, biased variance, decay 0.9, gradients
    through the batch statistics: output, input gradient and updated
    running statistics against JAX's mutated ``batch_stats`` (rtol 1e-5)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 24, 8).astype(np.float32) * 3 + 1
    mask = (rng.rand(2, 16, 24, 1) < 0.3).astype(np.float32)
    x = x * mask
    jmod = jsparse.MaskedBatchNorm()
    variables = perturb(jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), x, mask)), rng)
    probe = rng.randn(*x.shape).astype(np.float32)

    def jloss(xx):
        y, mutated = jmod.apply(variables, xx, mask, train=True, mutable=['batch_stats'])
        return jnp.sum(y * probe), (y, mutated['batch_stats'])

    (_, (want, stats)), want_grad = jax.value_and_grad(jloss, has_aux=True)(x)
    mod = sparse.MaskedBatchNorm(8)
    sd = {}
    batch_norm(sd, 'm', variables['params'], variables['batch_stats'])
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    xt = nchw(x).requires_grad_()
    got = mod.train()(xt, nchw(mask))
    (got * nchw(probe)).sum().backward()
    np.testing.assert_allclose(nhwc(got.detach()), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(want_grad), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.bn.running_mean.numpy(), stats['mean'], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(mod.bn.running_var.numpy(), stats['var'], rtol=1e-5,
                               atol=1e-7)


def test_packnet_train_forward_matches_jax(weights):
    """Training mode with LiDAR: the RGB pass, the RGBD pass and the
    feature-consistency ``depth_loss`` (rtol 1e-3), and the SAN running
    statistics the RGBD pass updates (rtol 1e-4)."""
    jtask = jtasks.build_task(train_config())
    batch = make_batch(2)
    out, mutated = jax.jit(lambda v, r, d: jtask.depth_net.apply(
        v, r, d, train=True, mutable=['batch_stats']))(weights, batch['rgb'],
                                                       batch['input_depth'])
    net = port_task(train_config(), weights).depth_net.train()
    with torch.no_grad():
        got = net(torch.from_numpy(batch['rgb']), torch.from_numpy(batch['input_depth']))
    for key in ('inv_depths', 'inv_depths_rgbd'):
        for s, (g, w) in enumerate(zip(got[key], out[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                       atol=1e-4, err_msg=f'{key} scale {s}')
    np.testing.assert_allclose(float(got['depth_loss']), float(out['depth_loss']),
                               rtol=1e-3)
    want_stats = state_dict_from_jax(weights['params'], mutated['batch_stats'])
    for name, t in net.state_dict().items():
        if name.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(t, want_stats[name], rtol=1e-4, atol=1e-6)


def test_dropout_drops_whole_channels():
    """Dropout2d on the residual shortcut: whole channels drop, the kept
    ones are scaled by 1/(1-p), the same generator seed gives the same
    mask, and eval does nothing."""
    x = torch.rand(3, 16, 8, 12) + 0.5
    y = blocks.channel_dropout(x, 0.5, torch.Generator().manual_seed(3))
    dropped = (y == 0).all(dim=(2, 3))
    kept = ~dropped
    assert dropped.any() and kept.any()
    assert torch.equal(y[kept], (x / 0.5)[kept])
    again = blocks.channel_dropout(x, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(y, again)
    block = blocks.ResidualConv(16, 16, dropout=0.5)
    with torch.no_grad():
        eval_out = block.eval()(x, torch.Generator().manual_seed(0))
        assert torch.equal(eval_out, block(x, torch.Generator().manual_seed(1)))
        train_a = block.train()(x, torch.Generator().manual_seed(2))
        train_b = block.train()(x, torch.Generator().manual_seed(2))
    assert torch.equal(train_a, train_b) and not torch.equal(train_a, eval_out)


@pytest.mark.parametrize('flip', [0.0, 1.0], ids=['noflip', 'flip'])
def test_train_loss_matches_jax(weights, flip):
    """``SemiSupEdgeTask.train_loss``: the loss and each metric (rtol 1e-4)
    and every parameter's gradient (1e-4 of its largest |gradient|)."""
    jcfg = train_config(flip_lr_prob=flip)
    jtask = jtasks.build_task(jcfg)
    batch = make_batch(3)

    def loss_fn(params):
        variables = {'depth': {'params': params, 'batch_stats': weights['batch_stats']}}
        loss, (metrics, _, _) = jtask.train_loss(variables, batch, jax.random.PRNGKey(5))
        return loss, metrics

    (want, want_metrics), want_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(weights['params'])
    task = port_task(jcfg, weights)
    loss, metrics = task.train_loss(to_torch(batch), torch.Generator().manual_seed(5))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    assert set(metrics) == set(want_metrics) == {'edge_loss', 'supervised_loss', 'loss'}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want_metrics[k]), rtol=1e-4, err_msg=k)
    assert_grads_close(grads_by_name(task.depth_net), want_grads)


def test_one_adam_step_matches_jax(weights):
    """One full train step against ``jax.jit(make_train_step(...))``:
    parameter deltas within lr/128, SAN running statistics at rtol 1e-4,
    ``grad_norm`` at rtol 1e-4 and the step count.

    Adam's first step moves a parameter by lr * g / (|g| + eps), about
    +-lr, so where |g| lies inside the gradients' fp32 noise (a vanishing
    tensor, or within ``GRAD_RTOL`` of its tensor's largest |gradient|) the
    sign is noise on both sides: there the step is held to |delta| <= lr
    (give or take an ulp of the parameter).
    Measured: 12 of 350,436 elements lie there and differ, by up to 2 lr.
    """
    jcfg = train_config()
    jtask = jtasks.build_task(jcfg)
    batch = make_batch(4)
    jvars = {'depth': weights}
    jopt = jbuild_optimizer(jcfg, {'depth': weights['params']}, steps_per_epoch=10)
    jstate = jcreate_state(jtask, jopt, jax.random.PRNGKey(0), batch, variables=jvars)
    jnew, jmetrics = jax.jit(jmake_step(jtask, jopt))(jstate, batch, jax.random.PRNGKey(0))

    task = port_task(jcfg, weights)
    state = create_train_state(port_config(jcfg), task.depth_net)
    before = {k: v.clone() for k, v in task.depth_net.state_dict().items()}
    metrics = make_train_step(task)(state, to_torch(batch), torch.Generator().manual_seed(0))
    assert state.step == int(jnew.step) == 1
    np.testing.assert_allclose(float(metrics['grad_norm']), float(jmetrics['grad_norm']),
                               rtol=1e-4)
    want_old = state_dict_from_jax(weights['params'], weights['batch_stats'])
    want_new = state_dict_from_jax(jnew.params['depth'], jnew.batch_stats['depth'])
    after = task.depth_net.state_dict()
    grads = grads_by_name(task.depth_net)
    top = max(float(g.abs().max()) for g in grads.values())
    for name, new in want_new.items():
        if name.endswith('num_batches_tracked'):
            continue
        if name.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(after[name], new, rtol=1e-4, atol=1e-6, msg=name)
            continue
        delta = after[name] - before[name]
        g = grads[name]
        noise = (torch.ones_like(g, dtype=torch.bool) if vanishing(g, top)
                 else g.abs() <= GRAD_RTOL * g.abs().max())
        off = (delta - (new - want_old[name])).abs()
        assert bool((off[~noise] <= LR / 128).all()), name
        # a parameter near 1 moves by lr give or take one fp32 ulp of it
        assert float(delta.abs().max()) <= LR * 1.001, name


def test_steplr_by_epoch_matches_jax(weights):
    """StepLR stepped once per epoch gives the JAX schedule's rate at every
    step of each epoch (``epoch = step // steps_per_epoch``)."""
    jcfg = train_config()
    task = port_task(jcfg, weights)
    state = create_train_state(port_config(jcfg), task.depth_net)
    schedule, spe = steplr(LR, 2, 0.5, steps_per_epoch=3), 3
    for epoch in range(7):
        for step in range(epoch * spe, (epoch + 1) * spe):
            assert state.optimizer.param_groups[0]['lr'] == pytest.approx(schedule(step))
        state.scheduler.step()
