"""Data-parallel training across processes: the rank workers, and the card
checks ``chip_smoke.py`` phase 11 runs.

This file imports neither JAX nor the JAX package, so the spawned ranks of
``tests/test_torch_dp.py`` (which holds them against the JAX package on the
CPU) and of ``chip_smoke.py`` import only torch and the port, and it runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_dp_cuda.py

``start_ranks(jobs, world, workdir)`` spawns ``world`` processes (the
``spawn`` start method, never ``fork``: the parent may hold JAX's threads)
that meet through a ``file://`` store in ``workdir`` (no TCP port, so
parallel test workers never collide), each with one CPU thread by default, and run
the jobs in turn, each job a function of this module called as
``job(rank, world, **kwargs)``; ``Ranks.result(i)`` waits for them and
gives job ``i``'s result on every rank, or raises with the ranks'
tracebacks.

On the card (``cuda`` marker, skipped without a device):

* ``dp_vs_plain``: a data-parallel step at world size 1 (NCCL) against the
  plain ``train_step`` from the same weights, batch and generator, held to
  4 times the card's run-to-run noise of two plain steps, and at least the
  card-vs-CPU gradient tolerance (as ``remat_vs_plain``);
* ``oracle_job`` and ``oracle_gaps``: two ranks over gloo on one card (both
  pass ``device='cuda:0'``; NCCL refuses two ranks on one GPU) take one
  data-parallel step at [2 per rank, 64, 96], channels (16,)*6; rank 0
  also takes the two ranks' plain steps alone on the card.  The step must
  equal that oracle (the mean of the two gradients, losses and running
  statistics) within the card-vs-CPU tolerances of ``train_step_card_vs_cpu``
  (loss rtol 1e-4, each gradient within 1e-4 of its tensor's largest,
  running statistics rtol 1e-4), and leave both ranks' parameters
  bit-equal.

``sharded_step_job`` takes ``make_sharded_train_step`` on the global batch
(``tests/test_torch_dp.py`` on the CPU against the JAX package;
``chip_smoke.py`` phase 11e on the card against rank 0's plain step), and
``timed_outcome`` is the one step (and timed steps) of any step maker that
it and the spatial jobs share.
"""

import datetime
import multiprocessing
import os
import sys
import time
import traceback
import uuid

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.models.packnet import to_train_device
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.parallel.mesh import (
    all_reduce_mean, make_dp_train_step, make_sharded_train_step)
from mindtheedge_tpu_torch.training.train_step import create_train_state
from tests.test_torch_train_cuda import (
    GRAD_RTOL, step_outcome, synthetic_batch, train_config, variants_vs_plain)

TIMEOUT_S = 600     # of a collective, and of waiting for the ranks


def _rank_main(rank, world, store, backend, jobs, out, threads, cudnn_benchmark_limit):
    torch.set_num_threads(threads)
    if cudnn_benchmark_limit is not None:
        torch.backends.cudnn.benchmark_limit = cudnn_benchmark_limit
    try:
        dist.init_process_group(backend, init_method=f'file://{store}', rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        for i, (job, kwargs) in enumerate(jobs):
            t0 = time.perf_counter()
            torch.save(job(rank, world, **kwargs), f'{out}.{i}.{rank}.pt')
            with open(f'{out}.{i}.{rank}.s', 'w') as f:
                f.write(repr(time.perf_counter() - t0))
    except BaseException:
        with open(f'{out}.{rank}.err', 'w') as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """The spawned ranks of :func:`start_ranks`; :meth:`join` waits
    ``wait_s`` for all of their jobs."""

    def __init__(self, procs, out, wait_s=TIMEOUT_S):
        self.procs, self.out, self.wait_s = procs, out, wait_s
        self._joined = False

    def join(self):
        if self._joined:
            return
        deadline = time.monotonic() + self.wait_s
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        alive = [p for p in self.procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
        self._joined = True
        if alive:
            raise TimeoutError(f'{len(alive)} rank(s) still running after {self.wait_s} s')

    def result(self, i):
        """Job ``i``'s result on every rank, in rank order."""
        self.join()
        paths = [f'{self.out}.{i}.{r}.pt' for r in range(len(self.procs))]
        if not all(os.path.exists(p) for p in paths):
            errors = [open(f'{self.out}.{r}.err').read() for r in range(len(self.procs))
                      if os.path.exists(f'{self.out}.{r}.err')]
            codes = [p.exitcode for p in self.procs]
            raise RuntimeError(f'job {i} has no result on every rank (exit codes '
                               f'{codes}):\n' + '\n'.join(errors))
        return [torch.load(p, weights_only=True) for p in paths]

    def seconds(self, i):
        """Job ``i``'s wall seconds on every rank, in rank order."""
        self.result(i)
        return [float(open(f'{self.out}.{i}.{r}.s').read()) for r in range(len(self.procs))]


def start_ranks(jobs, world, workdir, backend='gloo', threads=1, wait_s=TIMEOUT_S,
                cudnn_benchmark_limit=None):
    """Spawn ``world`` ranks of ``threads`` CPU threads each that run
    ``jobs`` ([(function, kwargs)]) in turn -> :class:`Ranks`, which waits
    ``wait_s`` for them all.  ``cudnn_benchmark_limit``, if given, is the
    number of cuDNN's candidate algorithms the ranks' autotuner times for
    each conv (``torch.backends.cudnn.benchmark_limit``; PyTorch's default
    is 10)."""
    os.makedirs(workdir, exist_ok=True)
    tag = uuid.uuid4().hex
    store = os.path.abspath(os.path.join(workdir, f'store-{tag}'))
    out = os.path.abspath(os.path.join(workdir, f'rank-{tag}'))
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, backend, jobs, out, threads,
                               cudnn_benchmark_limit))
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out, wait_s)


def cpu_tree(d):
    return {k: v.detach().cpu().clone() for k, v in d.items()}


# -- the jobs -------------------------------------------------------------------

def dp_step_job(rank, world, config, weights, batch, device='cpu'):
    """One data-parallel step of the task of the yaml ``config`` from the
    depth state dict in ``weights``, on this rank's chunk of the global
    numpy batch in ``batch`` (.npz), generator seed 0 -> its metrics, the
    gradients (averaged), the depth network's state after the step."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(config)
    task = build_task(cfg, device=device)
    task.depth_net.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    state = create_train_state(cfg, to_train_device(task.depth_net, device))
    with np.load(batch) as data:
        n = data['rgb'].shape[0] // world
        chunk = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]).to(device)
                 for k, v in data.items()}
    metrics = make_dp_train_step(task)(state, chunk, torch.Generator(device).manual_seed(0))
    return {'metrics': {k: float(v) for k, v in metrics.items()},
            'grads': {n: p.grad.cpu().clone() for n, p in task.depth_net.named_parameters()},
            'state': cpu_tree(task.depth_net.state_dict())}


def reduce_job(rank, world):
    """``reduce_value`` of rank + 1 (a Python scalar) and of a numpy array,
    and that array after both calls."""
    from mindtheedge_tpu_torch.utils.reduce import reduce_value
    value = np.array([rank + 1.0, 10.0 * rank])
    return {'sum': float(reduce_value(rank + 1, average=False)),
            'mean': float(reduce_value(float(rank + 1))),
            'array_sum': torch.tensor(reduce_value(value, average=False)),
            'array_mean': torch.tensor(reduce_value(value)),
            'array_after': torch.tensor(value)}


def fit_config(split, ckpt_dir, channels=(16,) * 6, h=64, w=96):
    """The paper's task at ``channels``, 1 epoch on the GTA split at batch
    1 per rank, validation on the same split, dropout 0, flip 0."""
    cfg = train_config(channels)
    cfg.arch.max_epochs = 1
    cfg.edges.depth_edges_metric_log = True
    cfg.datasets.augmentation.image_shape = (h, w)
    cfg.datasets.augmentation.jittering = ()
    for mode in ('train', 'validation'):
        ds = cfg.datasets[mode]
        ds.dataset, ds.path, ds.split = ['GTA'], [''], [split]
        ds.depth_type, ds.input_depth_type = ['groundtruth'], ['velodyne']
        ds.num_workers = 1
    cfg.datasets.train.batch_size = 1
    cfg.checkpoint.filepath = ckpt_dir
    return cfg


def fit_job(rank, world, split, ckpt_dir, device='cpu'):
    """``Experiment.fit`` of :func:`fit_config`, then ``validate`` again ->
    the steps and epoch, the loader's length, the networks' state, the
    validation means."""
    from mindtheedge_tpu_torch.training.experiment import Experiment
    exp = Experiment(fit_config(split, ckpt_dir), device=device)
    exp.fit()
    return {'step': exp.state.step, 'epoch': exp.state.epoch,
            'batches': len(exp.train_loader),
            'state': cpu_tree(exp.state.net.state_dict()),
            'val': {k: float(v) for k, v in exp.validate().items()}}


def infer_job(rank, world, argv, device='cpu'):
    """``infer_edges.main(argv)`` on this rank."""
    from mindtheedge_tpu_torch.cli import infer_edges
    infer_edges.main(argv, device=device)
    return {}


def writers_job(rank, world, stub_dir, out_dir):
    """A ``ModelCheckpoint`` with ``s3_path`` and a ``WandbLogger`` with
    ``dry_run`` False, ``stub_dir`` first on ``sys.path`` and ``PATH`` (a
    stub ``wandb`` module and a stub ``aws`` script that log their calls)
    -> this rank's pid and the checkpoint it wrote, or None."""
    from mindtheedge_tpu_torch.training.checkpoint import ModelCheckpoint
    from mindtheedge_tpu_torch.utils.wandb_logger import WandbLogger
    sys.path.insert(0, stub_dir)
    os.environ['PATH'] = stub_dir + os.pathsep + os.environ['PATH']
    cfg = get_cfg_defaults()
    state = create_train_state(cfg, torch.nn.Linear(2, 2))
    state.epoch = 1
    mgr = ModelCheckpoint(os.path.join(out_dir, 'ckpts'), monitor='loss', save_top_k=1,
                          s3_path='s3://bucket/run', s3_frequency=1)
    path = mgr.check_and_save(cfg, state, {'loss': 0.5})
    logger = WandbLogger(dir=out_dir, dry_run=False, project='mte')
    logger.log_config(cfg)
    logger.log_metrics({'train/loss': 0.5}, global_step=1)
    logger.finish()
    return {'pid': os.getpid(), 'path': path}


def oracle_job(rank, world, device, shape=(2, 64, 96), channels=(16,) * 6,
               full_config=None, full_batch=None, full_steps=3):
    """One data-parallel step of the paper's task (seeded weights, dropout
    0, flip 0) on this rank's ``shape[0]`` samples of a seeded global batch
    -> its loss, gradients and state; rank 0 also the oracle: each rank's
    plain step taken alone from the same weights, averaged.

    With ``full_config`` (a yaml) and ``full_batch`` (a ``torch.save``d
    batch), then ``full_steps`` data-parallel steps of that config on that
    batch after one warm-up -> ms of each by CUDA events, the peak memory,
    the ms of one all-reduce of the gradients alone (host clock,
    synchronised); and the NMS kernel's launches in this job alone."""
    from mindtheedge_tpu_torch.ops.cuda import nms_kernel
    nms_kernel.launches = 0
    cfg = train_config(channels)
    b, h, w = shape
    batch = synthetic_batch(np.random.RandomState(0), b * world, h, w)
    chunk = lambda r: {k: v[r * b:(r + 1) * b].to(device) for k, v in batch.items()}
    task = build_task(cfg, device=device)
    state = create_train_state(cfg, to_train_device(task.depth_net, device))
    metrics = make_dp_train_step(task)(state, chunk(rank),
                                       torch.Generator(device).manual_seed(0))
    out = {'loss': float(metrics['loss']),
           'grads': {n: p.grad.cpu().clone() for n, p in task.depth_net.named_parameters()},
           'state': cpu_tree(task.depth_net.state_dict())}
    if rank == 0:
        alone = [step_outcome(cfg, chunk(r), device, seed=0) for r in range(world)]
        mean = lambda trees: {k: sum(t[k].double() for t in trees) / world for k in trees[0]}
        stats = [{k: v for k, v in o[2].items() if k.endswith(('running_mean', 'running_var'))}
                 for o in alone]
        out['oracle'] = {'loss': float(np.mean([o[0] for o in alone])),
                         'grads': mean([o[1] for o in alone]), 'stats': mean(stats)}
    if full_config is not None:
        out['full'] = _full_width_steps(full_config, full_batch, full_steps, device)
    out['nms_launches'] = nms_kernel.launches
    return out


def _full_width_steps(config, batch_path, steps, device):
    cfg = get_cfg_defaults()
    cfg.merge_from_file(config)
    task = build_task(cfg, device=device)
    state = create_train_state(cfg, to_train_device(task.depth_net, device),
                               pose_net=task.pose_net)
    batch = {k: v.to(device) for k, v in torch.load(batch_path, weights_only=True).items()}
    step = make_dp_train_step(task)
    gen = torch.Generator(device).manual_seed(cfg.arch.seed)
    step(state, batch, gen)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    events[0].record()
    for i in range(steps):
        losses.append(step(state, batch, gen)['loss'])
        events[i + 1].record()
    events[-1].synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    grads = [p.grad for p in state.parameters()]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    all_reduce_mean(grads)
    torch.cuda.synchronize(device)
    return {'ms': [events[i].elapsed_time(events[i + 1]) for i in range(steps)],
            'peak': peak, 'all_reduce_ms': (time.perf_counter() - t0) * 1e3,
            'losses': [float(v) for v in losses],
            'parameters': sum(p.numel() for p in state.parameters())}


def timed_outcome(cfg, batch, make_step, dev, timed_steps=0, weights=None,
                  pose_weights=None, dtype=torch.float32):
    """One step made by ``make_step(task)`` of ``cfg``'s task (its seeded
    weights, or the depth and pose state dicts at ``weights`` and
    ``pose_weights``) on ``batch`` (whole frames, the global batch; lists
    of context frames too) on ``dev``, networks and batch in ``dtype``,
    generator seed 7 as ``step_outcome``; then ``timed_steps`` more, each
    timed by CUDA events, and the peak memory over them -> {'loss',
    'metrics', 'grads', 'state', with a pose net 'pose_grads', and with
    ``timed_steps`` 'ms', 'peak', 'losses'}."""
    to_dev = lambda x: x.to(dev, dtype) if x.is_floating_point() else x.to(dev)
    batch = {k: [to_dev(x) for x in v] if isinstance(v, list) else to_dev(v)
             for k, v in batch.items()}
    task = build_task(cfg, device=dev)
    if weights is not None:
        task.depth_net.load_state_dict(torch.load(weights, weights_only=True), strict=True)
    if pose_weights is not None:
        task.pose_net.load_state_dict(torch.load(pose_weights, weights_only=True), strict=True)
    for net in (task.depth_net, task.pose_net):
        if net is not None:
            net.to(dtype)
    state = create_train_state(cfg, to_train_device(task.depth_net, dev),
                               pose_net=task.pose_net)
    step = make_step(task)
    gen = torch.Generator(dev).manual_seed(7)
    metrics = step(state, batch, gen)
    grads = lambda net: {n: p.grad.cpu().clone() for n, p in net.named_parameters()}
    out = {'loss': float(metrics['loss']),
           'metrics': {k: float(v) for k, v in metrics.items()},
           'grads': grads(task.depth_net),
           'state': cpu_tree(task.depth_net.state_dict())}
    if task.pose_net is not None:
        out['pose_grads'] = grads(task.pose_net)
    if timed_steps:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(timed_steps + 1)]
        events[0].record()
        losses = []
        for i in range(timed_steps):
            losses.append(step(state, batch, gen)['loss'])
            events[i + 1].record()
        events[-1].synchronize()
        out.update(ms=[events[i].elapsed_time(events[i + 1]) for i in range(timed_steps)],
                   peak=torch.cuda.max_memory_allocated(dev),
                   losses=[float(v) for v in losses])
    return out


def sharded_step_job(rank, world, config, batch, weights=None, device='cpu', timed_steps=0,
                     oracle=False, pose_weights=None, dtype=torch.float32):
    """:func:`timed_outcome` of ``make_sharded_train_step`` for the task of
    the yaml ``config`` on the global batch in ``batch`` (a ``torch.save``d
    dict; every rank holds all of it), and the NMS kernel's launches in
    this job alone; with ``oracle``, rank 0 then also takes the plain step
    on the global batch alone (:func:`timed_outcome` of ``train_step``: the
    same weights and generator) -> 'oracle'."""
    from mindtheedge_tpu_torch.ops.cuda import nms_kernel
    from mindtheedge_tpu_torch.training.train_step import make_train_step
    nms_kernel.launches = 0
    cfg = get_cfg_defaults()
    cfg.merge_from_file(config)
    data = torch.load(batch, weights_only=True)
    kwargs = {'weights': weights, 'pose_weights': pose_weights, 'dtype': dtype}
    out = timed_outcome(cfg, data, make_sharded_train_step, device, timed_steps, **kwargs)
    if oracle and rank == 0:
        out['oracle'] = timed_outcome(cfg, data, make_train_step, device, **kwargs)
    out['nms_launches'] = nms_kernel.launches
    return out


def batch_norm_job(rank, world, x, cotangent, weight, bias):
    """``models/resnet.BatchNorm2d`` in training under a ``Space`` of every
    rank, on this rank's chunk of the global NCHW batch ``x`` (numpy, as
    ``weight``, ``bias`` and the output's ``cotangent``) -> its output,
    the gradients of <output, cotangent> with respect to its input, weight
    and bias, and its running statistics after the step."""
    from mindtheedge_tpu_torch.models.resnet import BatchNorm2d
    from mindtheedge_tpu_torch.parallel.spatial import Space
    bn = BatchNorm2d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.space = Space(world)
    mine = lambda a: torch.from_numpy(np.array_split(a, world)[rank])
    xr = mine(x).requires_grad_()
    y = bn(xr)
    (y * mine(cotangent)).sum().backward()
    return {'y': y.detach(), 'x_grad': xr.grad, 'weight_grad': bn.weight.grad,
            'bias_grad': bn.bias.grad, 'running_mean': bn.running_mean,
            'running_var': bn.running_var}


# -- the checks -----------------------------------------------------------------

def oracle_gaps(results):
    """Hold :func:`oracle_job`'s ranks to rank 0's oracle and to each other
    -> the worst (loss, gradient, running statistics) ratios."""
    first, oracle = results[0], results[0]['oracle']
    for r, res in enumerate(results[1:], 1):
        assert res['loss'] == first['loss'], f'rank {r} loss {res["loss"]} != {first["loss"]}'
        for k, v in first['state'].items():
            assert torch.equal(res['state'][k], v), f'rank {r} {k} differs from rank 0'
    loss = abs(first['loss'] - oracle['loss']) / abs(oracle['loss'])
    assert loss <= 1e-4, (first['loss'], oracle['loss'])
    top = max(float(g.abs().max()) for g in oracle['grads'].values())
    worst_grad = 0.0
    for name, want in oracle['grads'].items():
        scale = float(want.abs().max())
        vanishing = scale < 1e-5 * top
        err = float((first['grads'][name].double() - want).abs().max())
        tol = 1e-5 * top if vanishing else GRAD_RTOL * scale
        assert err <= tol, f'gradient {name}: {err} > {tol}'
        if not vanishing:
            worst_grad = max(worst_grad, err / scale)
    worst_stats = 0.0
    for name, want in oracle['stats'].items():
        got = first['state'][name].double()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6,
                                   msg=lambda m, name=name: f'{name}: {m}')
        worst_stats = max(worst_stats, float(((got - want).abs()
                                              / want.abs().clamp_min(1e-30)).max()))
    return {'loss': loss, 'grad': worst_grad, 'stats': worst_stats}


def dp_vs_plain(dev, cfg, batch):
    """One data-parallel step in the current process group against the
    plain step (see the module's docstring) -> (gaps, bound, noise)."""
    gaps, bound, noise = variants_vs_plain(
        dev, cfg, {'data-parallel': (cfg, make_dp_train_step)}, batch)
    return gaps['data-parallel'], bound, noise


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_nccl_world_one_step_matches_plain_step(cuda_card, tmp_path):
    dist.init_process_group('nccl', init_method=f'file://{tmp_path / "store"}',
                            rank=0, world_size=1)
    try:
        dp_vs_plain(cuda_card, train_config(), synthetic_batch(np.random.RandomState(0), 2, 64, 96))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_oracle(cuda_card, tmp_path):
    ranks = start_ranks([(oracle_job, {'device': 'cuda:0'})], 2, str(tmp_path))
    oracle_gaps(ranks.result(0))
