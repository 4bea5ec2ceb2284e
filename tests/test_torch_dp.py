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
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.make_synthetic_dataset import make_dataset
from tests.test_torch_blocks import perturb
from tests.test_torch_dp_cuda import (
    dp_step_job, fit_config, fit_job, infer_job, reduce_job, sharded_step_job, start_ranks,
    writers_job)
from tests.test_torch_spatial_cuda import step_gaps
from tests.test_torch_train_cuda import step_outcome, synthetic_batch
from tests.test_torch_train_cuda import train_config as train_config_cuda
from tests.test_torch_train_step import assert_grads_close, port_config, train_config
from tests.test_torch_train_tasks import f64

torch.set_num_threads(1)

WORLD, PER_RANK, H, W = 2, 2, 64, 64
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
                                'batch': str(tmp / 'batch.pt')})]
    ranks = start_ranks(jobs, WORLD, str(tmp / 'ranks'))
    try:
        with jax.enable_x64(True):
            opt = keep_gradient()
            mesh = make_mesh(jax.devices()[:WORLD])
            jstate = jcreate_state(jtask, opt, jax.random.PRNGKey(0), f64(batch),
                                   variables={'depth': f64(weights)})
            step = jmake_dp_step(jtask, opt, mesh)
            new_state, metrics = step(jstate, f64(batch), jax.random.PRNGKey(0))
            new_state = jax.tree_util.tree_map(np.asarray, new_state)
            jstate = jcreate_state(jtask, opt, jax.random.PRNGKey(0), f64(batch),
                                   variables={'depth': f64(weights)})
            sharded = jmake_sharded_step(jmake_train_step(jtask, opt), mesh)
            sharded_state, sharded_metrics = sharded(jstate, f64(batch), jax.random.PRNGKey(0))
            sharded_state = jax.tree_util.tree_map(np.asarray, sharded_state)
        plain_dropout = step_outcome(drop, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     'cpu')
        infer_edges.main(infer_argv(tmp, split, 'infer_single', 1), device='cpu')
        ranks.join()
    except BaseException:
        ranks.join()
        raise
    outcome = lambda state, metrics: {
        'metrics': {k: float(v) for k, v in metrics.items()},
        'grads': state.opt_state['depth'], 'stats': state.batch_stats['depth']}
    return {'ranks': ranks, 'tmp': tmp, 'split': split, 'stubs': stubs, 'weights': weights,
            'jax': outcome(new_state, metrics),
            'jax_sharded': outcome(sharded_state, sharded_metrics),
            'plain_dropout': plain_dropout}


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
    assert_grads_close(got['grads'], want['grads'])
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


def test_sharded_step_refuses_batch_norm2d():
    from mindtheedge_tpu_torch.models.tasks import build_task
    cfg = train_config_cuda()
    cfg.model.depth_net.name = 'DepthResNet'
    cfg.model.depth_net.version = '18'
    with pytest.raises(ValueError, match='BatchNorm2d'):
        make_sharded_train_step(build_task(cfg, device='cpu'))


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
