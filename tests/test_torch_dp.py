"""The port's data parallelism across processes on the CPU: two ranks over
gloo, spawned from this process (``tests/test_torch_dp_cuda.start_ranks``:
they import only torch and the port), against the JAX package.

* One data-parallel step of the paper's ``SemiSupEdgeModel`` at [2 per
  rank, 64, 64], channels (16,)*6, dropout 0, ``flip_lr_prob`` 0, from the
  JAX weights carried over by ``utils/weights.state_dict_from_jax``,
  against the JAX package's ``make_dp_train_step`` over
  ``jax.devices()[:2]`` of the 8-device CPU mesh (``tests/conftest.py``) on
  the same global batch: the loss and metrics rtol 1e-4, each gradient
  within ``GRAD_RTOL`` (3e-4) of its tensor's largest (as
  tests/test_torch_train_step.py holds one process's step), the running
  statistics rtol 1e-4; the metrics, gradients and state equal on both
  ranks.  The JAX step runs in fp64 (``jax.enable_x64``, its weights and
  batch cast to float64): against its fp32 gradients the port's worst
  tensor lay at 0.73 of the bound (measured on the CPU), within 2x of
  it.  The JAX step's gradients are read from an optax transformation
  that keeps them as its state.
* ``reduce_value``, the loader's rank chunks against the JAX loader's
  global batches, ``Experiment.fit`` on two ranks (one writer),
  ``infer_edges --dp 2`` against one process (the f32 wire within 1e-5, as
  tests/test_cli_dp.py), the rules of ``maybe_initialize_distributed``,
  the S3 sync and the Weights & Biases run from rank 0 only (a stub
  ``aws`` and a stub ``wandb``), and ``arch.dp_devices`` without a group.

The ranks run their jobs while this process compiles the JAX step.
"""

import json
import os
import stat
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.distributed as dist

from mindtheedge_tpu.data.loader import DataLoader as JaxDataLoader
from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.parallel.mesh import make_dp_train_step as jmake_dp_step, make_mesh
from mindtheedge_tpu.parallel.mesh import make_sharded_train_step as jmake_sharded_step
from mindtheedge_tpu.training.train_step import create_train_state as jcreate_state
from mindtheedge_tpu.training.train_step import make_train_step as jmake_train_step
from mindtheedge_tpu_torch.cli import infer_edges
from mindtheedge_tpu_torch.data.loader import DataLoader
from mindtheedge_tpu_torch.parallel.mesh import make_sharded_train_step
from mindtheedge_tpu_torch.parallel.distributed import maybe_initialize_distributed
from mindtheedge_tpu_torch.training.checkpoint import ModelCheckpoint
from mindtheedge_tpu_torch.training.experiment import Experiment
from mindtheedge_tpu_torch.training.train_step import create_train_state
from mindtheedge_tpu_torch.utils.reduce import reduce_value
from mindtheedge_tpu_torch.utils.wandb_logger import WandbLogger
from mindtheedge_tpu_torch.utils.weights import pose_state_dict_from_jax, state_dict_from_jax
from tests.make_synthetic_dataset import make_dataset
from tests.test_torch_blocks import perturb
from tests.test_torch_dp_cuda import (
    batch_norm_job, dp_step_job, fit_config, fit_job, infer_job, reduce_job, sharded_step_job,
    start_ranks, writers_job)
from tests.test_torch_generic_tasks import LOSS_GRAD_L2, POSE_GRAD_L2, generic_config
from tests.test_torch_spatial_cuda import step_gaps
from tests.test_torch_train_cuda import step_outcome, synthetic_batch
from tests.test_torch_train_cuda import train_config as train_config_cuda
from tests.test_torch_train_step import GRAD_RTOL, assert_grads_close, port_config, train_config
from tests.test_torch_train_tasks import (
    biased_variables, depth_sd, f64, selfsup_batch, task_config, to_torch)

torch.set_num_threads(1)

WORLD, PER_RANK, H, W = 2, 2, 64, 64
# make_sharded_train_step on the ResNet depth networks at [2 per rank, 64,
# 96]: the JAX task's config and the dtype of the port's side
# (test_sharded_resnet_step_matches_jax_make_sharded_train_step says why)
RESNET_TASKS = {
    'DepthResNet': (lambda: task_config('SelfSupModel', depth_net='DepthResNet',
                                        pose_net='PoseNet'), torch.float32),
    'RaySurfaceResNet': (generic_config, torch.float64),
}
FRAMES = 6      # the GTA split of the fit and the inference: a ragged last batch
INFER_BATCH = 4

STUB_WANDB = '''import os
LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'wandb_calls.txt')


def _log(what):
    with open(LOG, 'a') as f:
        f.write(f'{os.getpid()} {what}\\n')


class _Config:
    def update(self, values, allow_val_change=False):
        _log('config')


config = _Config()


def init(**kwargs):
    _log(f"init {kwargs.get('project')}")


def log(metrics):
    _log('log ' + ' '.join(sorted(metrics)))


def finish():
    _log('finish')
'''


def keep_gradient():
    """An optax transformation that updates nothing and keeps the gradient
    it was given as its state."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)
    return optax.GradientTransformation(lambda params: zeros(params),
                                        lambda grads, state, params=None: (zeros(grads), grads))


def write_stubs(root):
    os.makedirs(root)
    with open(os.path.join(root, 'wandb.py'), 'w') as f:
        f.write(STUB_WANDB)
    aws = os.path.join(root, 'aws')
    with open(aws, 'w') as f:
        f.write(f'#!/bin/sh\necho "$PPID $*" >> {root}/aws_calls.txt\n')
    os.chmod(aws, os.stat(aws).st_mode | stat.S_IEXEC)
    return root


def infer_argv(tmp, split, name, dp):
    import yaml
    cfg = {
        'model': {'name': 'SemiSupEdgeModel',
                  'depth_net': {'name': 'PackNetSAN01', 'version': '1A',
                                'channels': [16] * 6}},
        'datasets': {'augmentation': {'image_shape': [64, 96]},
                     'test': {'dataset': ['GTA'], 'path': [''], 'split': [split],
                              'input_depth_type': ['velodyne'],
                              'depth_type': ['groundtruth']}},
        'save': {'folder': str(tmp / name)},
        'checkpoint': {'filepath': str(tmp / 'missing.ckpt')},
    }
    path = tmp / f'{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return ['--config', str(path), '--batch', str(INFER_BATCH), '--dp', str(dp),
            '--wire', 'f32']


def resnet_batch():
    """The ResNet steps' global batch: ``selfsup_batch`` of seeds 6 and 7
    (tests/test_torch_train_tasks.py), 4 samples at [64,96]."""
    parts = selfsup_batch(6), selfsup_batch(7)
    cat = lambda a, b: [np.concatenate(p) for p in zip(a, b)] if isinstance(a, list) \
        else np.concatenate([a, b])
    return {k: cat(parts[0][k], parts[1][k]) for k in parts[0]}


def numpy_variables(jcfg, batch, seed=0):
    """``tests/test_torch_train_tasks.jax_variables`` without JAX's jitted
    init, which compiles both networks: every kernel drawn from N(0,
    1/fan_in) with numpy on the tree of ``jax.eval_shape``, every other
    leaf zero, then perturbed and the heads biased as there."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key != 'kernel':
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    shapes = jax.eval_shape(jtasks.build_task(jcfg).init, jax.random.PRNGKey(seed), batch)
    return biased_variables(jax.tree_util.tree_map_with_path(draw, shapes), seed)


def resnet_job(tmp, name):
    """The files of ``RESNET_TASKS[name]``'s sharded step (its port yaml,
    the networks of :func:`numpy_variables`, the global batch) -> (the
    ranks' ``sharded_step_job``, rank 0 also taking the plain step on the
    global batch; the JAX config, variables and batch)."""
    make, dtype = RESNET_TASKS[name]
    jcfg, batch = make(), resnet_batch()
    variables = numpy_variables(jcfg, batch)
    files = {k: str(tmp / f'{name}_{k}') for k in ('config', 'batch', 'weights', 'pose_weights')}
    port_config(jcfg).save_yaml(files['config'])
    torch.save(to_torch(batch), files['batch'])
    depth, pose = variables['depth'], variables['pose']
    torch.save(depth_sd(depth['params'], depth.get('batch_stats')), files['weights'])
    torch.save(pose_state_dict_from_jax(pose['params']), files['pose_weights'])
    return (sharded_step_job, dict(files, oracle=True, dtype=dtype)), (jcfg, variables, batch)


def jax_sharded_step(jcfg, variables, batch, mesh):
    """The JAX package's ``make_sharded_train_step`` of ``jcfg``'s task over
    ``mesh``, in fp64 -> its metrics, gradients ({network: tree}) and the
    depth network's running statistics after the step."""
    jtask = jtasks.build_task(jcfg)
    opt = keep_gradient()
    with jax.enable_x64(True):
        jstate = jcreate_state(jtask, opt, jax.random.PRNGKey(0), f64(batch),
                               variables=f64(variables))
        step = jmake_sharded_step(jmake_train_step(jtask, opt), mesh)
        state, metrics = step(jstate, f64(batch), jax.random.PRNGKey(0))
        state = jax.tree_util.tree_map(np.asarray, state)
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': state.opt_state, 'stats': state.batch_stats['depth']}


BN_SHAPE = (4, 3, 5, 6)     # the BatchNorm2d unit test's global NCHW batch


def batch_norm_inputs():
    rng = np.random.RandomState(4)
    return {'x': (rng.randn(*BN_SHAPE) * 2 + 1).astype(np.float32),
            'cotangent': rng.randn(*BN_SHAPE).astype(np.float32),
            'weight': rng.uniform(0.5, 1.5, BN_SHAPE[1]).astype(np.float32),
            'bias': rng.randn(BN_SHAPE[1]).astype(np.float32)}


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    """The ranks' jobs, started first, and meanwhile the JAX step and the
    single-process inference."""
    tmp = tmp_path_factory.mktemp('dp')
    jcfg = train_config()
    jtask = jtasks.build_task(jcfg)
    batch = {k: v.numpy() for k, v in
             synthetic_batch(np.random.RandomState(0), WORLD * PER_RANK, H, W).items()}
    variables = jax.jit(jtask.init)(jax.random.PRNGKey(0),
                                    {k: v[:PER_RANK] for k, v in batch.items()})
    depth = jax.tree_util.tree_map(np.asarray, variables['depth'])
    weights = {'params': perturb(depth['params'], np.random.RandomState(1)),
               'batch_stats': depth['batch_stats']}
    port_config(jcfg).save_yaml(str(tmp / 'train.yaml'))
    torch.save(state_dict_from_jax(weights['params'], weights['batch_stats']),
               tmp / 'weights.pt')
    np.savez(tmp / 'batch.npz', **batch)
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, tmp / 'batch.pt')
    drop = train_config_cuda(dropout=0.5, flip_lr_prob=0.5)
    drop.save_yaml(str(tmp / 'dropout.yaml'))
    split = make_dataset(str(tmp / 'synth'), n=FRAMES, h=64, w=96)
    stubs = write_stubs(str(tmp / 'stubs'))
    jobs = [(dp_step_job, {'config': str(tmp / 'train.yaml'),
                           'weights': str(tmp / 'weights.pt'),
                           'batch': str(tmp / 'batch.npz')}),
            (reduce_job, {}),
            (writers_job, {'stub_dir': stubs, 'out_dir': str(tmp / 'writers')}),
            (fit_job, {'split': split, 'ckpt_dir': str(tmp / 'fit')}),
            (infer_job, {'argv': infer_argv(tmp, split, 'infer_dp', WORLD)}),
            (sharded_step_job, {'config': str(tmp / 'train.yaml'), 'batch': str(tmp / 'batch.pt'),
                                'weights': str(tmp / 'weights.pt')}),
            (sharded_step_job, {'config': str(tmp / 'dropout.yaml'),
                                'batch': str(tmp / 'batch.pt')}),
            (batch_norm_job, batch_norm_inputs())]
    bn_job = len(jobs) - 1
    # JAX's sharded steps compile in threads beside the rest
    pool = ThreadPoolExecutor(3)
    resnet, resnet_jobs = {}, {}
    for name, (job, resnet[name]) in zip(RESNET_TASKS, pool.map(
            lambda name: resnet_job(tmp, name), RESNET_TASKS)):
        resnet_jobs[name] = len(jobs)
        jobs.append(job)
    mesh = make_mesh(jax.devices()[:WORLD])
    ranks = start_ranks(jobs, WORLD, str(tmp / 'ranks'))
    try:
        jax_sharded = pool.submit(jax_sharded_step, jcfg, {'depth': weights}, batch, mesh)
        jax_resnet = {name: pool.submit(jax_sharded_step, *args, mesh)
                      for name, args in resnet.items()}
        with jax.enable_x64(True):
            opt = keep_gradient()
            jstate = jcreate_state(jtask, opt, jax.random.PRNGKey(0), f64(batch),
                                   variables={'depth': f64(weights)})
            step = jmake_dp_step(jtask, opt, mesh)
            new_state, metrics = step(jstate, f64(batch), jax.random.PRNGKey(0))
            new_state = jax.tree_util.tree_map(np.asarray, new_state)
        plain_dropout = step_outcome(drop, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     'cpu')
        infer_edges.main(infer_argv(tmp, split, 'infer_single', 1), device='cpu')
        jax_sharded = jax_sharded.result()
        jax_resnet = {name: f.result() for name, f in jax_resnet.items()}
        ranks.join()
    except BaseException:
        ranks.join()
        raise
    finally:
        pool.shutdown(cancel_futures=True)
    return {'ranks': ranks, 'tmp': tmp, 'split': split, 'stubs': stubs, 'weights': weights,
            'jax': {'metrics': {k: float(v) for k, v in metrics.items()},
                    'grads': new_state.opt_state['depth'],
                    'stats': new_state.batch_stats['depth']},
            'jax_sharded': jax_sharded,
            'plain_dropout': plain_dropout, 'jax_resnet': jax_resnet,
            'resnet_jobs': resnet_jobs, 'bn_job': bn_job}


def test_dp_step_matches_jax_make_dp_train_step(dp):
    got, other = dp['ranks'].result(0)
    want = dp['jax']
    assert set(got['metrics']) == set(want['metrics'])
    for k, v in want['metrics'].items():
        np.testing.assert_allclose(got['metrics'][k], v, rtol=1e-4, err_msg=k)
    assert other['metrics'] == got['metrics']
    assert_grads_close(got['grads'], want['grads'])
    want_stats = state_dict_from_jax(dp['weights']['params'], want['stats'])
    stats = [k for k in want_stats if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in stats:
        torch.testing.assert_close(got['state'][k], want_stats[k], rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: f'{k}: {m}')
    for k, v in got['grads'].items():
        assert torch.equal(other['grads'][k], v), k
    for k, v in got['state'].items():
        assert torch.equal(other['state'][k], v), k


def test_sharded_step_matches_jax_make_sharded_train_step(dp):
    """``make_sharded_train_step`` on 2 ranks (2 samples each of the
    global batch of 4, the SAN active, dropout 0 and flip 0 as every JAX
    parity) against the JAX package's ``make_sharded_train_step`` over 2
    virtual devices in fp64: the loss rtol 1e-5, the metrics rtol 1e-4,
    the gradients within ``GRAD_RTOL`` of each tensor's largest, the
    running statistics (taken over the global batch) rtol 1e-4; both ranks
    equal."""
    results = dp['ranks'].result(5)
    got, want = results[0], dp['jax_sharded']
    np.testing.assert_allclose(got['loss'], want['metrics']['loss'], rtol=1e-5)
    assert set(got['metrics']) == set(want['metrics'])
    for k, v in want['metrics'].items():
        np.testing.assert_allclose(got['metrics'][k], v, rtol=1e-4, err_msg=k)
    assert_grads_close(got['grads'], want['grads']['depth'])
    want_stats = state_dict_from_jax(dp['weights']['params'], want['stats'])
    stats = [k for k in want_stats if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in stats:
        torch.testing.assert_close(got['state'][k], want_stats[k], rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: f'{k}: {m}')
    for res in results[1:]:
        assert res['metrics'] == got['metrics']
        for k, v in got['grads'].items():
            assert torch.equal(res['grads'][k], v), k


def test_sharded_step_draws_what_the_plain_step_draws(dp):
    """With dropout 0.5 and flip 0.5 (generator seed 7 on every rank) the
    sharded step equals the port's plain step on the global batch:
    ``tests/test_torch_spatial_cuda.step_gaps``' bounds (loss rtol 1e-5,
    gradients 1e-4 of each tensor's largest, statistics rtol 1e-4)."""
    results = dp['ranks'].result(6)
    step_gaps(results[0], dp['plain_dropout'])
    for res in results[1:]:
        for k, v in results[0]['grads'].items():
            assert torch.equal(res['grads'][k], v), k


def within_own_band(got, plain, want, net):
    """Each of the gradients ``got`` within ``GRAD_RTOL`` of its largest
    |``want``|, or within twice ``plain``'s error against ``want``,
    whichever is larger; a tensor whose largest |gradient| is below 1e-5 of
    the network's vanishes analytically: within 1e-5 of that."""
    assert set(got) == set(want), net
    top = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        scale, w = float(w.abs().max()), w.double()
        err = float((got[name].double() - w).abs().max())
        own = float((plain[name].double() - w).abs().max())
        tol = 1e-5 * top if scale < 1e-5 * top else max(GRAD_RTOL * scale, 2 * own)
        assert err <= tol, f'{net}.{name}: {err} > {tol}'


@pytest.mark.parametrize('name', list(RESNET_TASKS))
def test_sharded_resnet_step_matches_jax_make_sharded_train_step(dp, name):
    """``make_sharded_train_step`` on 2 ranks of 2 samples each (the global
    batch of 4 at [64,96]) against the JAX package's over 2 virtual
    devices in fp64, from the same networks (``jax_variables``): the loss
    rtol 1e-5, the metrics rtol 1e-4 and the depth ResNet's running
    statistics rtol 1e-4 (taken over the global batch: a chunk's would
    part by far more); both ranks equal.

    ``SelfSupModel`` + ``DepthResNet`` 18 + ``PoseNet``, the port in fp32:
    each gradient tensor within ``GRAD_RTOL`` (3e-4) of its largest, or
    within twice the port's own plain fp32 step's error against the same
    JAX step (rank 0's oracle), whichever is larger; a tensor below 1e-5
    of the network's largest within 1e-5 of that.  The band: at this batch
    of 4 the port's plain fp32 step itself lies up to 5.9e-3 of a tensor's
    largest from JAX's fp64 one in the pose net (``conv1.1.bias``; 8.1e-4
    by relative L2 over the pose net, 1.1e-5 over the depth net; measured
    on the CPU), so what is held is that sharding adds nothing to fp32's
    own rounding; :func:`test_sharded_resnet_step_equals_plain_step` holds
    the sharded step to that plain step at 1e-4.

    ``GenericSelfSupModel`` + ``RaySurfaceResNet`` 18 + ``PoseNet``, the
    port in fp64, each network's gradient by relative L2 as
    tests/test_torch_generic_tasks.py holds the loss's (1e-2 depth, 5e-2
    pose), ``grad_norm`` within the depth bound (the norm of a gradient
    moves no more than the gradient).  Its fp32 step is ill-conditioned on
    any device (the soft argmax at a temperature of 1e-4, ROADMAP L4): the
    port's fp32 step lies 0.054 / 0.045 (depth / pose) from JAX's fp64 one
    by relative L2, its fp64 step 5.0e-4 / 4.4e-4 (measured on the CPU),
    while its sharded and plain fp64 steps agree to ~1e-11
    (:func:`test_sharded_resnet_step_equals_plain_step`): JAX's step under
    ``enable_x64`` is not fp64 throughout."""
    results = dp['ranks'].result(dp['resnet_jobs'][name])
    got, want = results[0], dp['jax_resnet'][name]
    fp32 = RESNET_TASKS[name][1] == torch.float32
    np.testing.assert_allclose(got['loss'], want['metrics']['loss'], rtol=1e-5)
    assert set(got['metrics']) == set(want['metrics'])
    for k, v in want['metrics'].items():
        rtol = 1e-4 if fp32 or k != 'grad_norm' else LOSS_GRAD_L2
        np.testing.assert_allclose(got['metrics'][k], v, rtol=rtol, err_msg=k)
    nets = (('grads', want['grads']['depth'], depth_sd, LOSS_GRAD_L2),
            ('pose_grads', want['grads']['pose'], pose_state_dict_from_jax, POSE_GRAD_L2))
    for key, tree, convert, bound in nets:
        want_sd = convert(tree)
        if fp32:
            within_own_band(got[key], got['oracle'][key], want_sd, key)
            continue
        flat = lambda sd: torch.cat([sd[k].double().reshape(-1) for k in sorted(want_sd)])
        l2 = float((flat(got[key]) - flat(want_sd)).norm() / flat(want_sd).norm())
        assert l2 <= bound, (key, l2)
    want_stats = depth_sd(jax.tree_util.tree_map(np.zeros_like, want['grads']['depth']),
                          want['stats'])
    stats = [k for k in want_stats if k.endswith(('running_mean', 'running_var'))]
    assert stats
    for k in stats:
        torch.testing.assert_close(got['state'][k].double(), want_stats[k].double(),
                                   rtol=1e-4, atol=1e-6, msg=lambda m, k=k: f'{k}: {m}')
    for res in results[1:]:
        assert res['metrics'] == got['metrics']
        for key in ('grads', 'pose_grads', 'state'):
            for k, v in got[key].items():
                assert torch.equal(res[key][k], v), (key, k)


@pytest.mark.parametrize('name', list(RESNET_TASKS))
def test_sharded_resnet_step_equals_plain_step(dp, name):
    """The same sharded step against the port's plain step on the global
    batch, taken by rank 0 alone from the same networks and generator:
    ``tests/test_torch_spatial_cuda.step_gaps``' bounds (loss rtol 1e-5,
    gradients 1e-4 of each tensor's largest, statistics rtol 1e-4), the
    pose network's gradients too; both ranks bit-equal.

    ``DepthResNet`` in fp32 (its BatchNorm2d sums its chunks where the
    plain step sums the batch at once: the two round apart), and
    ``RaySurfaceResNet`` in fp64 (the test above says why)."""
    results = dp['ranks'].result(dp['resnet_jobs'][name])
    got, plain = results[0], results[0]['oracle']
    step_gaps(got, (plain['loss'], plain['grads'], plain['state']))
    step_gaps({'loss': got['loss'], 'grads': got['pose_grads'], 'state': {}},
              (plain['loss'], plain['pose_grads'], {}))
    for k, v in got['grads'].items():
        assert torch.equal(results[1]['grads'][k], v), k


def test_batch_norm2d_under_a_space_matches_one_batch_norm(dp):
    """``models/resnet.BatchNorm2d`` in training, a ``Space`` of the 2
    ranks, each on its half of a [4,3,5,6] batch, against one
    ``BatchNorm2d`` on the whole batch: its output, the input gradient of
    <output, cotangent>, the weight and bias gradients summed over the
    ranks, and the running statistics (global mean and biased variance,
    momentum 0.1, equal on both ranks), rtol 1e-5, atol 1e-6."""
    from mindtheedge_tpu_torch.models.resnet import BatchNorm2d
    inputs = batch_norm_inputs()
    bn = BatchNorm2d(BN_SHAPE[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs['weight']))
        bn.bias.copy_(torch.from_numpy(inputs['bias']))
    x = torch.from_numpy(inputs['x']).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inputs['cotangent'])).sum().backward()
    got = dp['ranks'].result(dp['bn_job'])
    close = lambda a, b, what: torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                                          msg=lambda m: f'{what}: {m}')
    close(torch.cat([r['y'] for r in got]), y.detach(), 'output')
    close(torch.cat([r['x_grad'] for r in got]), x.grad, 'input gradient')
    close(sum(r['weight_grad'] for r in got), bn.weight.grad, 'weight gradient')
    close(sum(r['bias_grad'] for r in got), bn.bias.grad, 'bias gradient')
    for k in ('running_mean', 'running_var'):
        close(got[0][k], getattr(bn, k), k)
        assert torch.equal(got[1][k], got[0][k]), k


def test_sharded_step_raises_for_an_output_it_does_not_know():
    """An output of the depth net that the step neither gathers nor
    reduces raises rather than reach the losses as one rank's chunk."""
    from mindtheedge_tpu_torch.models.tasks import build_task
    task = build_task(train_config_cuda(), device='cpu')
    make_sharded_train_step(task)
    with pytest.raises(ValueError, match=r"does not know the depth net's outputs \['depth'\]"):
        task.output_hook({'inv_depths': [torch.zeros(2, 4, 4, 1)], 'depth': torch.zeros(2)})


def test_reduce_value_sums_and_means(dp):
    for res in dp['ranks'].result(1):
        assert res['sum'] == 3.0 and res['mean'] == 1.5
        assert res['array_sum'].tolist() == [3.0, 10.0]
        assert res['array_mean'].tolist() == [1.5, 5.0]
    assert [r['array_after'].tolist() for r in dp['ranks'].result(1)] == \
        [[1.0, 0.0], [2.0, 10.0]]
    value = np.array([1.0, 2.0])
    assert reduce_value(value) is value and reduce_value(3, average=False) == 3


class Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'idx': i}


@pytest.mark.parametrize('world', [2, 3])
def test_loader_rank_chunks_are_jax_global_batches(world):
    """Training: rank r's batch of each step is the r-th chunk of the JAX
    loader's global batch of ``B x world`` (so their concatenation is it),
    and both count the same steps; evaluation: the JAX loader's rank stride."""
    data, b = Indices(23), 3
    for epoch in (0, 1):
        want = JaxDataLoader(data, batch_size=b * world, shuffle=True, drop_last=True,
                             seed=5)
        want.set_epoch(epoch)
        want = [x['idx'] for x in want]
        got = []
        for r in range(world):
            loader = DataLoader(data, batch_size=b, shuffle=True, drop_last=True, seed=5,
                                rank=r, world_size=world)
            loader.set_epoch(epoch)
            assert len(loader) == len(want)
            got.append([x['idx'] for x in loader])
        assert len(want) == 23 // (b * world)
        for step, global_batch in enumerate(want):
            np.testing.assert_array_equal(
                np.concatenate([got[r][step] for r in range(world)]), global_batch)
    for r in range(world):
        got = [x['idx'] for x in DataLoader(data, batch_size=b, rank=r, world_size=world)]
        want = [x['idx'] for x in JaxDataLoader(data, batch_size=b, rank=r,
                                                world_size=world)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_fit_on_two_ranks_writes_once_from_rank_zero(dp):
    results = dp['ranks'].result(3)
    for res in results:
        assert (res['step'], res['epoch'], res['batches']) == (FRAMES // WORLD, 1, FRAMES // WORLD)
        assert res['val'] == results[0]['val']
    for k, v in results[0]['state'].items():
        assert torch.equal(results[1]['state'][k], v), k
    ckpt_dir = dp['tmp'] / 'fit'
    files = sorted(os.listdir(ckpt_dir))
    ckpts = [f for f in files if f.endswith('.ckpt')]
    assert len(ckpts) == 1 and files == sorted(ckpts + ['code.tar.gz', 'metrics.jsonl'])
    rows = [json.loads(ln) for ln in (ckpt_dir / 'metrics.jsonl').read_text().splitlines()]
    assert len(rows) == 2 and 'train/loss' in rows[0] and 'val/depth/abs_rel' in rows[1]
    # the ranks' validation sums and counts make the single process's mean
    exp = Experiment(fit_config(dp['split'], str(dp['tmp'] / 'unused')), device='cpu')
    exp.task.depth_net.load_state_dict(results[0]['state'])
    want = exp.validate()
    assert set(want) == set(results[0]['val'])
    for k, v in want.items():
        np.testing.assert_allclose(results[0]['val'][k], v, rtol=1e-6, atol=1e-9, err_msg=k)


def test_infer_edges_dp_matches_single_process(dp):
    dp['ranks'].result(4)
    single, multi = dp['tmp'] / 'infer_single', dp['tmp'] / 'infer_dp'
    for i in range(FRAMES):
        want = np.load(single / f'{i:08d}_regular.npy')
        got = np.load(multi / f'{i:08d}_regular.npy')
        assert want.shape == (64, 96)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (multi / 'pred_list.txt').read_text() == \
        (single / 'pred_list.txt').read_text().replace(str(single), str(multi))


def test_s3_sync_and_wandb_run_from_rank_zero_only(dp):
    first, second = dp['ranks'].result(2)
    assert first['path'] and second['path'] is None
    aws = (open(os.path.join(dp['stubs'], 'aws_calls.txt')).read().splitlines())
    assert aws == [f'{first["pid"]} s3 cp {first["path"]} s3://bucket/run']
    calls = open(os.path.join(dp['stubs'], 'wandb_calls.txt')).read().splitlines()
    assert calls == [f'{first["pid"]} init mte', f'{first["pid"]} config',
                     f'{first["pid"]} log global_step train/loss', f'{first["pid"]} finish']
    out = dp['tmp'] / 'writers'
    assert sorted(os.listdir(out)) == ['ckpts']
    assert sorted(os.listdir(out / 'ckpts')) == sorted(
        [os.path.basename(first['path']), 'code.tar.gz'])


def test_writers_fall_back_without_wandb_and_aws(tmp_path, monkeypatch, capsys):
    """One process: ``dry_run`` False without ``wandb`` writes the JSONL
    file; an S3 sync whose ``aws`` is missing prints and goes on."""
    monkeypatch.setitem(__import__('sys').modules, 'wandb', None)
    monkeypatch.setenv('PATH', str(tmp_path))
    mgr = ModelCheckpoint(str(tmp_path / 'ckpts'), s3_path='s3://bucket/run')
    state = create_train_state(fit_config('', ''), torch.nn.Linear(2, 2))
    path = mgr.check_and_save(fit_config('', ''), state, {'loss': 0.5})
    assert os.path.exists(path)
    logger = WandbLogger(dir=str(tmp_path), dry_run=False)
    logger.log_metrics({'train/loss': 0.5}, global_step=1)
    logger.finish()
    rows = (tmp_path / 'metrics.jsonl').read_text().splitlines()
    assert len(rows) == 1 and json.loads(rows[0])['train/loss'] == 0.5
    out = capsys.readouterr().out
    assert 'S3 sync of' in out and 'wandb is not installed' in out


LAUNCH = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK',
          'MTE_DISTRIBUTED', 'SLURM_JOB_ID', 'SLURM_PROCID', 'SLURM_NTASKS',
          'SLURM_LOCALID', 'OMPI_COMM_WORLD_SIZE', 'OMPI_COMM_WORLD_RANK',
          'OMPI_COMM_WORLD_LOCAL_RANK')


@pytest.mark.parametrize('env,raises', [
    ({}, None),
    ({'MTE_DISTRIBUTED': '0', 'MASTER_ADDR': 'localhost', 'MASTER_PORT': '1',
      'RANK': '0', 'WORLD_SIZE': '2', 'LOCAL_RANK': '0'}, None),
    ({'SLURM_JOB_ID': '7', 'SLURM_PROCID': '0', 'SLURM_NTASKS': '2'}, None),
    ({'MASTER_ADDR': 'localhost', 'MASTER_PORT': '1', 'RANK': '0', 'LOCAL_RANK': '0'},
     'WORLD_SIZE is missing'),
    ({'MTE_DISTRIBUTED': '1'}, 'MASTER_ADDR and MASTER_PORT and RANK and WORLD_SIZE'),
], ids=['no-launcher', 'disabled', 'slurm-without-address', 'no-world-size', 'forced'])
def test_maybe_initialize_distributed_rules(monkeypatch, env, raises):
    for name in LAUNCH:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if raises:
        with pytest.raises(RuntimeError, match=raises):
            maybe_initialize_distributed('cpu')
    else:
        assert maybe_initialize_distributed('cpu') is False
    assert not dist.is_initialized()


def test_dp_devices_without_a_group_raises():
    cfg = fit_config('', '')
    cfg.arch.dp_devices = 2
    with pytest.raises(ValueError, match='torchrun --nproc_per_node 2'):
        Experiment(cfg, load_datasets=False, device='cpu')
