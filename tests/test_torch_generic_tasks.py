"""The generic ray-surface tasks of the port against the JAX package's:
``RaySurfaceResNet`` (training and eval outputs, running statistics),
``GenericSfmModel`` (zero loss; its eval output, the ray surface included,
with and without the lr-flip) and ``GenericSelfSupModel`` (the loss, its
metrics and gradients at progress 0 and 0.5, reduced by 'min' and by
'mean'; the network's backward; the whole ``train_loss``), and
``cli.train_edges.main`` for 1 epoch of ``GenericSelfSupModel`` on a
synthetic KITTI tree against the JAX package's ``Experiment.fit``.

64x96, batch 2, ResNet-18 + ``PoseNet``, weights carried over by
``utils/weights``; the depth heads biased to ~5 m and the pose head to a
few pixels of motion (tests/test_torch_train_tasks.py).  Tolerances:
forwards rtol 1e-4, atol 1e-5; the loss and metrics rtol 1e-4 and the
network's backward 3e-4 of each gradient's largest, as
tests/test_torch_train_tasks.py; the loss's own gradients as
``test_generic_selfsup_loss_matches_jax`` states; the epoch's mean losses
rtol 1e-2 (tests/test_torch_train_cli.py), the smoothness term 2e-2 (its
test says why).
"""

import copy
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.models import resnet as jresnet
from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.training.checkpoint import save_checkpoint as jsave_checkpoint
from mindtheedge_tpu.training.experiment import Experiment as JaxExperiment
from mindtheedge_tpu.training.state import split_variables
from mindtheedge_tpu_torch.cli import train_edges
from mindtheedge_tpu_torch.models import resnet
from mindtheedge_tpu_torch.utils.weights import (
    pose_state_dict_from_jax, raysurface_state_dict_from_jax)
from tests.test_torch_blocks import perturb
from tests.test_torch_variants_cuda import pinhole_rays
from tests.test_torch_train_cli import (
    ckpts, kitti_config, port_yaml, shape_of, train_metrics, write_pose_checkpoint)
from tests.test_torch_train_cuda import smooth_images, write_kitti_tree
from tests.test_torch_train_tasks import (
    GRAD_RTOL, depth_head_bias, jax_variables, port_config, port_task, selfsup_batch,
    task_config, to_torch)
from tests.test_torch_train_step import B, H, W

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
# test_generic_selfsup_loss_matches_jax says why
LOSS_GRAD_MAX, LOSS_GRAD_L2, POSE_GRAD_L2 = 0.1, 1e-2, 5e-2


def generic_config(name='GenericSelfSupModel', **loss):
    """The JAX package's config of a generic task: RaySurfaceResNet 18 and
    PoseNet, every scale upsampled to full size (the default), as each
    scale's patch must fit in the half-size image."""
    return task_config(name, depth_net='RaySurfaceResNet', pose_net='PoseNet',
                       upsample_depth_maps=True, **loss)


@pytest.fixture(scope='module')
def raysurface():
    rng = np.random.RandomState(0)
    rgb = rng.rand(B, H, W, 3).astype(np.float32)
    jmodel = jresnet.RaySurfaceResNet()
    variables = jax.jit(lambda k, r: jmodel.init(k, r, train=False))(
        jax.random.PRNGKey(0), rgb)
    variables = perturb(jax.tree_util.tree_map(np.asarray, variables), rng)
    net = resnet.RaySurfaceResNet()
    net.load_state_dict(raysurface_state_dict_from_jax(
        variables['params'], variables['batch_stats']), strict=True)
    return jmodel, variables, net, rgb


def assert_close(got, want, what):
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_raysurface_resnet_matches_jax(raysurface, train):
    """4 inverse depths in training and scale 0 at eval, the ray surface
    [B,H,W,3] in both, and the batch statistics a training pass leaves."""
    jmodel, variables, net, rgb = raysurface
    want, mutated = jax.jit(lambda v, r: jmodel.apply(
        v, r, train=train, mutable=['batch_stats']))(variables, rgb)
    net.load_state_dict(raysurface_state_dict_from_jax(
        variables['params'], variables['batch_stats']))
    with torch.no_grad():
        got = net.train(train)(torch.from_numpy(rgb))
    assert set(got) == set(want) == {'inv_depths', 'ray_surface'}
    assert len(got['inv_depths']) == len(want['inv_depths']) == (4 if train else 1)
    for s, (g, w) in enumerate(zip(got['inv_depths'], want['inv_depths'])):
        assert_close(g, w, f'inv_depths[{s}]')
    assert_close(got['ray_surface'], want['ray_surface'], 'ray_surface')
    if train:
        sd = raysurface_state_dict_from_jax(variables['params'], mutated['batch_stats'])
        for name, t in net.state_dict().items():
            if name.endswith(('running_mean', 'running_var')):
                torch.testing.assert_close(t, sd[name], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('flip', [False, True], ids=['plain', 'flipped'])
def test_generic_sfm_task_matches_jax(flip):
    """``train_loss`` is 0 with the metric ``loss`` alone; ``infer`` returns
    scale 0 and the ray surface as JAX's does, which flips the inverse
    depth back and leaves the ray surface as computed on the flipped
    input."""
    jcfg = generic_config('GenericSfmModel')
    batch = selfsup_batch(3)
    variables = jax_variables(jcfg, batch)
    jtask, task = jtasks.build_task(jcfg), port_task(jcfg, variables)
    want = jax.jit(lambda v, b: jtask.infer(v, b, force_flip=flip))(variables, batch)
    tbatch = to_torch(batch)
    got = task.infer(tbatch, force_flip=flip)
    assert_close(got['inv_depths'][0], want['inv_depths'][0], 'inv_depths[0]')
    assert_close(got['ray_surface'], want['ray_surface'], 'ray_surface')
    loss, metrics = task.train_loss(tbatch, torch.Generator())
    assert float(loss) == 0.0 and set(metrics) == {'loss'}


def generic_outputs(rng):
    """Depth-network outputs for the loss alone: 4 smooth inverse depths in
    [0.05, 0.5] (2-20 m) at full size, as ``upsample_depth_maps`` leaves
    them, and a pinhole camera's unit rays as the ray surface."""
    maps = smooth_images(rng, 2, B, H, W)
    inv = [np.ascontiguousarray(0.05 + 0.45 * m[..., c:c + 1]) for m in maps for c in (0, 1)]
    return inv, pinhole_rays(B, H, W)


@pytest.mark.parametrize('progress,reduce_op', [(0.0, 'min'), (0.5, 'mean')])
def test_generic_selfsup_loss_matches_jax(progress, reduce_op):
    """``GenericSelfSupTask.losses`` on given depth outputs (smooth inverse
    depths, pinhole rays) with the JAX pose network's weights, against the
    JAX task's ``train_loss`` on the same outputs: loss and metrics (rtol
    1e-4), and the gradients with respect to the inverse depths, the ray
    surface and the pose network's parameters, against JAX and against the
    port in fp64.

    The gradient bounds are wider than the depth networks' 3e-4, because
    fp32 cannot do better here: a point between two rays, or two contexts
    whose errors nearly tie under the 'min' reduction, is decided by
    rounding, and the near-hard soft argmax multiplies a rounding by 1/T =
    1e4.  Measured on these inputs, for the inverse depths and the ray
    surface: JAX's own fp32 gradients lie up to 3.5e-2 of a tensor's
    largest from the port's fp64 ones (a relative L2 error up to 7.4e-3),
    the port's up to 3.5e-2 (L2 6.7e-3).  The pose network's fp32 output
    moves those tie points too: its parameters' gradients lay up to a
    relative L2 error of 2.9e-2 from fp64 in the port and 1.5e-3 in JAX,
    and 1.4e-3 in the port with the pose network alone in fp64, single
    elements up to 0.12 of their tensor's largest.  Bounds: each tensor of
    the loss's inputs within 0.1 of its largest and within a relative L2
    error of 1e-2; each pose parameter tensor within a relative L2 error of
    5e-2.  A pose tensor whose
    gradient vanishes analytically (a conv bias before a one-channel
    GroupNorm group) is held within 1e-5 of the network's largest."""
    jcfg = generic_config(photometric_reduce_op=reduce_op)
    batch = selfsup_batch(3)
    variables = jax_variables(jcfg, batch)
    inv, rays = generic_outputs(np.random.RandomState(4))
    jtask = jtasks.build_task(jcfg)
    jtask.run_depth = lambda v, b, train, rng=None, force_flip=False: (
        {'inv_depths': v['outputs'][0], 'ray_surface': v['outputs'][1]}, None)

    def loss_fn(pose_params, outputs):
        v = dict(variables, pose=dict(variables['pose'], params=pose_params), outputs=outputs)
        loss, (metrics, _, _) = jtask.train_loss(
            v, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(5), progress)
        return loss, metrics

    (want, want_metrics), (want_pose, want_out) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables['pose']['params'], (inv, rays))
    want_grads = {'inv_depths.' + str(s): np.asarray(g) for s, g in enumerate(want_out[0])}
    want_grads['ray_surface'] = np.asarray(want_out[1])
    want_grads.update({'pose.' + k: v.numpy() for k, v in
                       pose_state_dict_from_jax(want_pose).items()})
    sides = {}
    for dtype in (torch.float32, torch.float64):
        task = port_task(jcfg, variables)
        task.pose_net.to(dtype)
        t = lambda a: torch.from_numpy(np.array(a)).to(dtype)
        tbatch = {k: [x.to(dtype) for x in v] if isinstance(v, list) else v.to(dtype)
                  for k, v in to_torch(batch).items()}
        out = {'inv_depths': [t(d).requires_grad_() for d in inv],
               'ray_surface': t(rays).requires_grad_()}
        loss, metrics = task.losses(tbatch, out, progress)
        loss.backward()
        grads = {f'inv_depths.{s}': d.grad for s, d in enumerate(out['inv_depths'])}
        grads['ray_surface'] = out['ray_surface'].grad
        grads.update({'pose.' + n: p.grad for n, p in task.pose_net.named_parameters()})
        sides[dtype] = loss, metrics, {k: g.double().numpy() for k, g in grads.items()}
    loss, metrics, grads = sides[torch.float32]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    assert set(metrics) == set(want_metrics) == {'photometric_loss', 'smoothness_loss', 'loss'}
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want_metrics[k]), rtol=1e-4, err_msg=k)
    assert set(grads) == set(want_grads)
    pose_top = max(np.abs(g).max() for k, g in want_grads.items() if k.startswith('pose.'))
    for name, w in want_grads.items():
        top = np.abs(w).max()
        for other, g in (('jax', w), ('fp64', sides[torch.float64][2][name])):
            err = grads[name] - g
            if name.startswith('pose.') and top < 1e-5 * pose_top:
                assert np.abs(err).max() <= 1e-5 * pose_top, (name, other)
                continue
            l2 = np.linalg.norm(err) / np.linalg.norm(g)
            if name.startswith('pose.'):
                assert l2 <= POSE_GRAD_L2, (name, other, l2)
                continue
            assert np.abs(err).max() <= LOSS_GRAD_MAX * top, (name, other, np.abs(err).max() / top)
            assert l2 <= LOSS_GRAD_L2, (name, other, l2)


def test_raysurface_resnet_backward_matches_jax(raysurface):
    """The training pass's backward from seeded cotangents on the 4 inverse
    depths and the ray surface, against ``jax.vjp`` in fp64 (the fixture's
    parameters, statistics, image and cotangents cast to float64 under
    ``jax.enable_x64``): the port's fp32 gradient of each parameter within
    3e-4 of its tensor's largest (the depth networks' bound,
    tests/test_torch_train_tasks.py), its fp64 gradient within 1e-6.

    The yardstick is fp64 because JAX's own fp32 gradient is what wanders
    here: measured on the CPU, worst over all parameters, over the
    tensor's largest, JAX fp32 lies 5.98e-3 from JAX fp64 (and differently
    from run to run), the port's fp32 1.72e-5 and the port's fp64 5.6e-8."""
    jmodel, variables, net, rgb = raysurface
    rng = np.random.RandomState(7)
    cot_inv = [rng.randn(B, H >> s, W >> s, 1) for s in range(4)]
    cot_rs = rng.randn(B, H, W, 3)
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
        stats = f64(variables['batch_stats'])

        def fwd(params):
            out, _ = jmodel.apply({'params': params, 'batch_stats': stats},
                                  rgb.astype(np.float64), train=True, mutable=['batch_stats'])
            return out['inv_depths'], out['ray_surface']

        _, vjp = jax.vjp(fwd, f64(variables['params']))
        grads = vjp((cot_inv, cot_rs))[0]
        assert all(g.dtype == jnp.float64 for g in jax.tree_util.tree_leaves(grads))
        want = raysurface_state_dict_from_jax(f64(grads))
    for dtype, rtol in ((torch.float32, GRAD_RTOL), (torch.float64, 1e-6)):
        port = copy.deepcopy(net).to(dtype)
        port.load_state_dict(raysurface_state_dict_from_jax(
            variables['params'], variables['batch_stats']))
        port.train().zero_grad()
        t = lambda a: torch.from_numpy(a).to(dtype)
        out = port(t(rgb))
        (sum((d * t(c)).sum() for d, c in zip(out['inv_depths'], cot_inv))
         + (out['ray_surface'] * t(cot_rs)).sum()).backward()
        for name, p in port.named_parameters():
            w = want[name].double()
            torch.testing.assert_close(p.grad.double(), w, rtol=0,
                                       atol=rtol * float(w.abs().max()),
                                       msg=lambda m, name=name: f'{dtype} {name}: {m}')


def test_generic_selfsup_train_loss_matches_jax():
    """The whole ``train_loss`` (RaySurfaceResNet, PoseNet, the loss) at
    progress 0.5: loss and metrics rtol 1e-4, every gradient finite and the
    ray-surface head's nonzero.  Gradients are not compared here: the
    untrained ray surface puts near-ties in many patches, where fp32 is
    ill-conditioned at a temperature of 1e-4 (measured: JAX's own fp32
    gradients up to 0.66 of a tensor's largest off the port's fp64 ones,
    the port's fp32 ones 0.19); the two tests above hold the loss's
    gradients on pinhole rays and the network's backward apart."""
    jcfg = generic_config()
    batch = selfsup_batch(3)
    variables = jax_variables(jcfg, batch)
    jtask = jtasks.build_task(jcfg)
    want, (want_metrics, _, _) = jax.jit(lambda v, b: jtask.train_loss(
        v, b, jax.random.PRNGKey(5), 0.5))(variables, batch)
    task = port_task(jcfg, variables)
    loss, metrics = task.train_loss(to_torch(batch), torch.Generator(), 0.5)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    assert set(metrics) == set(want_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(want_metrics[k]), rtol=1e-4, err_msg=k)
    for net in (task.depth_net, task.pose_net):
        assert all(bool(torch.isfinite(p.grad).all()) for p in net.parameters())
    assert float(task.depth_net.ray_surf.decoder[10].conv.weight.grad.abs().max()) > 0


def test_generic_selfsup_needs_a_pose_network():
    cfg = port_config(generic_config())
    cfg.model.pose_net.name = ''
    from mindtheedge_tpu_torch.models import tasks
    with pytest.raises(ValueError, match='model.pose_net.name'):
        tasks.build_task(cfg, device='cpu').check_trainable()


def write_raysurface_checkpoint(path, jcfg):
    """A JAX-format checkpoint of perturbed RaySurfaceResNet parameters
    (disparity heads at ~5 m), the batch statistics at their init values
    (the JAX trainer loads parameters only)."""
    jtask = jtasks.build_task(jcfg)
    sample = {'rgb': np.zeros((1, H, W, 3), np.float32)}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jtask.init)(jax.random.PRNGKey(0), sample))
    params, stats = split_variables(variables)
    params = {'depth': depth_head_bias(perturb(params['depth'], np.random.RandomState(0)))}
    state = types.SimpleNamespace(
        epoch=0, step=0, params=params, batch_stats=stats,
        opt_state=jax.tree_util.tree_map(np.asarray, optax.adam(1e-3).init(params)))
    jsave_checkpoint(str(path), jcfg, state)
    return str(path)


def test_train_edges_generic_epoch_matches_jax(tmp_path):
    """``GenericSelfSupModel`` for 1 epoch (2 steps of batch 2, one back and
    one forward context frame) through ``cli.train_edges.main`` on the
    CPU and through the JAX package's ``Experiment.fit``: the epoch's mean
    loss and photometric term within rtol 1e-2, the smoothness term within
    2e-2, and the checkpoint names.  The smoothness term (~1e-4) is the one
    that reacts most to the second step's weights, and this loss's fp32
    gradient is noisy at the percent level (measured on the batch of
    ``test_generic_selfsup_train_loss_matches_jax``: the depth network's
    gradient norm 3.950 in the port's fp32, 3.973 in JAX's, 3.862 in the
    port's fp64), so Adam's first step differs in sign where the gradient
    lies in that noise; measured 1.04e-2 apart."""
    tree = str(tmp_path / 'kitti')
    split = write_kitti_tree(tree, n_frames=6, h=H, w=W, no_gt=())
    pose_ckpt, pose_params = write_pose_checkpoint(tmp_path / 'pose.ckpt')

    def jcfg(ckpt_dir, init=''):
        cfg = kitti_config(tree, split, ckpt_dir, init, pose_ckpt)
        cfg.model.name = 'GenericSelfSupModel'
        cfg.model.depth_net.name = 'RaySurfaceResNet'
        cfg.model.depth_net.version = ''
        cfg.model.loss.upsample_depth_maps = True
        return jconfig.prepare_config(cfg)

    init = write_raysurface_checkpoint(tmp_path / 'init.ckpt', jcfg(''))
    jdir, pdir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    jexp = JaxExperiment(jcfg(jdir, init))
    jexp.initialize_state(next(iter(jexp.train_loader)))
    jexp.state = jexp.state.replace(params=dict(jexp.state.params, pose=pose_params))
    jexp.fit()
    exp = train_edges.main([port_yaml(jcfg(pdir, init), str(tmp_path / 'port.yaml'))],
                           device='cpu')
    got, want = train_metrics(pdir), train_metrics(jdir)
    rtols = {'train/loss': 1e-2, 'train/photometric_loss': 1e-2,
             'train/smoothness_loss': 2e-2}
    assert set(rtols) <= set(got) and set(rtols) <= set(want)
    for k, rtol in rtols.items():
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert shape_of(ckpts(pdir)) == shape_of(ckpts(jdir))
    assert exp.state.step == 2 and isinstance(exp.state.net, resnet.RaySurfaceResNet)
    assert os.path.exists(os.path.join(pdir, ckpts(pdir)[-1]))
