"""Spatial sharding across processes: the rank workers, and the card checks
``chip_smoke.py`` phase 12 runs.

This file imports neither JAX nor the JAX package, so the spawned ranks of
``tests/test_torch_spatial.py`` and ``tests/test_torch_spatial_train.py``
(which hold them against the JAX package on the CPU) and of
``chip_smoke.py`` import only torch and the port, and it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_spatial_cuda.py

The ranks are spawned by ``tests/test_torch_dp_cuda.start_ranks``; each job
is a function of this module called as ``job(rank, world, **kwargs)``.
A grid is ``(n_h, n_w)`` as ``parallel.spatial.Space`` takes it.

On the card (``cuda`` marker, skipped without a device), at channels
(16,)*6 with the SAN branch and 95 %-sparse LiDAR:

* ``test_space_of_one_on_card_matches_plain_forward``: the sharded code
  path with a space of one (NCCL, world 1: zero-pad exchanges, the
  all-reduced GroupNorm) against the unsharded forward on the card,
  [2,128,96], within rtol 1e-4, atol 1e-5;
* ``test_two_gloo_ranks_on_one_card_match_plain``: two ranks over gloo on
  one card (NCCL refuses two ranks on one GPU), H over 2: the gathered
  forward against the unsharded card forward (rtol 1e-4, atol 1e-5), and
  one ``make_spatial_train_step`` step of the paper's task at [2,128,64]
  against the plain card step (loss rtol 1e-5, each gradient within 1e-4
  of its tensor's largest, running statistics rtol 1e-4).

``chip_smoke.py`` phase 12 runs ``card_pair_job`` at full width in fp32
and, with ``dtype=torch.bfloat16`` and a bf16 config, in bf16, and
``gloo_dtype_job`` first, which reports the collectives that take bf16
tensors on the card.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.models.packnet import PackNetSAN, to_train_device
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.parallel.mesh import make_spatial_train_step
from mindtheedge_tpu_torch.training.train_step import create_train_state
from tests.test_torch_dp_cuda import cpu_tree, start_ranks, timed_outcome
from tests.test_torch_train_cuda import GRAD_RTOL, step_outcome, synthetic_batch, train_config

CHANNELS = (16,) * 6
HALO_GRIDS = ((4, None), (None, 4), (2, 2))     # H over 4, W over 4, 2 x 2


def nchw_block(x, space):
    """This rank's block of an NCHW tensor."""
    return spatial.shard_spatial(x.permute(0, 2, 3, 1), space).permute(0, 3, 1, 2)


def halo_cotangent(rank, shape):
    """The seeded cotangent rank ``rank`` feeds back through an exchanged
    block of ``shape``."""
    return torch.from_numpy(np.random.RandomState(1000 + rank).rand(*shape).astype(np.float32))


def halo_job(rank, world, x, grids=HALO_GRIDS, halos=(1, 2, 3)):
    """``halo_exchange`` of this rank's block of ``x`` (NCHW numpy) for
    each grid and halo, and the gradient of <exchanged, cotangent> -> {grid
    and halo: (exchanged block, gradient)}."""
    out = {}
    for grid in grids:
        space = spatial.Space(*grid)
        for p in halos:
            block = nchw_block(torch.from_numpy(x), space).clone().requires_grad_()
            y = spatial.halo_exchange(block, p, space)
            (y * halo_cotangent(rank, y.shape)).sum().backward()
            out[f'{grid}/{p}'] = (y.detach(), block.grad)
    return out


def load_net(state_dict, device='cpu'):
    """PackNet-SAN 1A at ``CHANNELS`` from ``state_dict`` (a path or a
    dict), in eval mode on ``device``."""
    net = PackNetSAN(CHANNELS)
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, weights_only=True)
    net.load_state_dict(state_dict, strict=True)
    return net.to(device).eval()


def sharded_forward(net, space, rgb, lidar):
    """``make_spatial_infer`` of ``net`` on this rank's blocks of the full
    NHWC ``rgb`` and ``lidar`` -> the 4 gathered inverse depths and the
    collectives of one forward."""
    infer = spatial.make_spatial_infer(net, space, with_depth=lidar is not None)
    space.counts = dict.fromkeys(space.counts, 0)
    local = infer(spatial.shard_spatial(rgb, space), spatial.shard_spatial(lidar, space))
    counts = dict(space.counts)
    return [spatial.gather_spatial(d, space) for d in local], counts


def forward_job(rank, world, weights, cases, device='cpu', dtype=torch.float32):
    """The sharded eval forward of each case ({name: (grid, rgb, lidar)},
    NHWC numpy), the network and inputs in ``dtype`` -> rank 0: {name: 4
    gathered inverse depths}; the others: whether theirs equal rank 0's
    (all ranks of a replica gather the same frame)."""
    out = {}
    for name, (grid, rgb, lidar) in cases.items():
        space = spatial.Space(*grid)
        got, _ = sharded_forward(load_net(weights, device).to(dtype), space,
                                 torch.from_numpy(rgb).to(device, dtype),
                                 torch.from_numpy(lidar).to(device, dtype))
        got = [d.cpu() for d in got]
        gathered = [torch.empty_like(d) for d in got]
        for g, d in zip(gathered, got):
            dist.broadcast(g if rank else d, src=0)
        out[name] = got if rank == 0 else all(torch.equal(a, b) for a, b in zip(got, gathered))
    return out


def blocky_frames(rng, b, h, w):
    """[b,h,w,3] rgb in [0, 1] as ``tests/make_synthetic_dataset`` draws it:
    a blocky depth scene times 3 plus noise of 5 grey levels, uint8."""
    depth = np.full((b, h, w), 30.0)
    for i in range(b):
        for _ in range(3):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            depth[i, y:y + rng.randint(8, h // 2), x:x + rng.randint(8, w // 2)] = \
                rng.uniform(5, 25)
    grey = np.clip(depth * 3 + rng.randn(b, h, w) * 5, 0, 255).astype(np.uint8)
    return np.repeat(grey[..., None], 3, -1).astype(np.float32) / 255.0


def fp64_job(rank, world, grid, shape):
    """On blocky frames of ``shape`` (B, H, W), the seeded (16,)*6 network
    (no LiDAR): the sharded fp32 forward's and the plain fp32 forward's
    largest relative error against the plain fp64 forward, at each
    scale."""
    b, h, w = shape
    rgb = torch.from_numpy(blocky_frames(np.random.RandomState(0), b, h, w))
    net = serve.build(CHANNELS, device='cpu', seed=0)
    with torch.no_grad():
        exact = net.double()(rgb.double())['inv_depths']
        plain = net.float()(rgb)['inv_depths']
    sharded, _ = sharded_forward(net, spatial.Space(*grid), rgb, None)
    rel = lambda got: [float(((g.double() - e).abs() / e.abs()).max())
                       for g, e in zip(got, exact)]
    return {'sharded': rel(sharded), 'plain': rel(plain)}


def train_job(rank, world, config, batch, grid, depth_weights=None, pose_weights=None,
              remat=(), precision=None, device='cpu'):
    """One ``make_spatial_train_step`` of the task of the yaml ``config``
    (its seeded weights, or the state dicts at ``depth_weights`` and
    ``pose_weights``; ``arch.precision`` set to ``precision`` if given) on
    this rank's data replica's share of the global numpy batch in
    ``batch`` (.npz; lists as ``key.i``), generator seed 0, then the same
    with each ``remat`` mode -> {'metrics', 'grads' (depth and pose,
    averaged), 'state' (the depth network's after the step), 'remat':
    {mode: (metrics, grads)}}."""
    space = spatial.Space(*grid)
    with np.load(batch) as data:
        n = next(iter(data.values())).shape[0] // space.n_data
        arrays = {k: torch.from_numpy(v[space.data * n:(space.data + 1) * n]).to(device)
                  for k, v in data.items()}
    chunk = {k: v for k, v in arrays.items() if '.' not in k}
    for key in sorted({k.split('.')[0] for k in arrays if '.' in k}):
        chunk[key] = [arrays[f'{key}.{i}'] for i in range(sum(
            k.startswith(key + '.') for k in arrays))]

    def one(mode):
        cfg = get_cfg_defaults()
        cfg.merge_from_file(config)
        cfg.model.depth_net.remat = mode
        if precision is not None:
            cfg.arch.precision = precision
        task = build_task(cfg, device=device)
        if depth_weights:
            task.depth_net.load_state_dict(torch.load(depth_weights, weights_only=True))
        if pose_weights:
            task.pose_net.load_state_dict(torch.load(pose_weights, weights_only=True))
        state = create_train_state(cfg, to_train_device(task.depth_net, device),
                                   pose_net=task.pose_net)
        metrics = make_spatial_train_step(task, space)(
            state, chunk, torch.Generator(device).manual_seed(0))
        grads = {f'{tag}.{n}': p.grad.cpu().clone() for tag, net in
                 (('depth', task.depth_net), ('pose', task.pose_net)) if net is not None
                 for n, p in net.named_parameters()}
        return ({k: float(v) for k, v in metrics.items()}, grads,
                cpu_tree(task.depth_net.state_dict()))

    metrics, grads, state = one(False)
    return {'metrics': metrics, 'grads': grads, 'state': state,
            'remat': {mode: one(mode)[:2] for mode in remat}}


def card_pair_job(rank, world, full_config=None, full_batch=None, full_forward=None,
                  steps=3, dtype=torch.float32):
    """Two gloo ranks sharing ``cuda:0``, H over ``world``: without
    ``full_config``, the gathered forward of :func:`small_card_inputs`
    and one spatial step of the paper's task at [2,128,64]; with
    ``full_config``, ``full_batch`` and ``full_forward`` (paths), the
    full-width forward of ``serve.build``'s seeded SLIM network in
    ``dtype`` on the request in ``full_forward`` and one step of that
    config on that batch, then ``steps`` timed steps -> their outcomes
    (the inverse depths as fp32), times, peak memory and the collectives
    of one forward, and the NMS and GroupNorm + ELU kernels' launches in
    this job alone."""
    from mindtheedge_tpu_torch.ops.cuda import gn_elu_kernel, nms_kernel
    nms_kernel.launches = gn_elu_kernel.launches = 0
    dev = torch.device('cuda:0')
    space = spatial.Space(world)
    out = {}
    if full_config is None:
        net, rgb, lidar, _ = small_card_inputs(dev)
        out['small_forward'] = [d.cpu() for d in sharded_forward(net, space, rgb, lidar)[0]]
        batch = synthetic_batch(np.random.RandomState(0), 2, 128, 64)
        out['small_step'] = timed_outcome(train_config(), batch, spatial_step(space), dev)
    else:
        request = {k: v.to(dev, dtype) for k, v in
                   torch.load(full_forward, weights_only=True).items()}
        net = serve.build(device=dev, seed=0, dtype=dtype)
        got, counts = sharded_forward(net, space, request['rgb'], request['lidar'])
        out['full_forward'] = [d.float().cpu() for d in got]
        out['forward_counts'] = counts
        out['forward_ms'] = _forward_ms(net, space, request, dev)
        del net
        full = get_cfg_defaults()
        full.merge_from_file(full_config)
        batch = {k: v.to(dev) for k, v in torch.load(full_batch, weights_only=True).items()}
        out['full_step'] = timed_outcome(full, batch, spatial_step(space), dev,
                                         timed_steps=steps)
    out['nms_launches'] = nms_kernel.launches
    out['gn_elu_launches'] = gn_elu_kernel.launches
    return out


def gloo_dtype_job(rank, world, device, dtype=torch.bfloat16):
    """Whether each collective of the spatial and data-parallel paths takes
    ``dtype`` tensors on ``device`` in this process group -> {collective:
    'ok' or the error}."""
    x = torch.full((4,), rank + 1.0, device=device, dtype=dtype)
    calls = {
        'all_gather_into_tensor': lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=device, dtype=dtype), x),
        'all_reduce': lambda: dist.all_reduce(x.clone()),
        'reduce_scatter_tensor': lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device=device, dtype=dtype), x.clone()),
        'broadcast': lambda: dist.broadcast(x.clone(), src=0)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = 'ok'
        except Exception as e:
            out[name] = f'{type(e).__name__}: {e}'
    return out


def cli_job(rank, world, argv, device='cpu'):
    """``infer_edges.main(argv)`` on this rank -> its wall seconds and the
    NMS and GroupNorm + ELU kernels' launches in this job alone."""
    from mindtheedge_tpu_torch.cli import infer_edges
    from mindtheedge_tpu_torch.ops.cuda import gn_elu_kernel, nms_kernel
    nms_kernel.launches = gn_elu_kernel.launches = 0
    t0 = time.perf_counter()
    infer_edges.main(argv, device=device)
    return {'seconds': time.perf_counter() - t0, 'nms_launches': nms_kernel.launches,
            'gn_elu_launches': gn_elu_kernel.launches}


def _forward_ms(net, space, request, dev, iters=3):
    """ms of the sharded forward on this rank by CUDA events, after one
    warm-up, and the peak memory over the timed forwards; and of each halo
    exchange alone (host clock, synchronised)."""
    infer = spatial.make_spatial_infer(net, space, with_depth=True)
    rgb = spatial.shard_spatial(request['rgb'], space)
    lidar = spatial.shard_spatial(request['lidar'], space)
    infer(rgb, lidar)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    dist.barrier()
    events[0].record()
    for _ in range(iters):
        infer(rgb, lidar)
    events[1].record()
    events[1].synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    x = torch.rand(rgb.shape[0], 32, rgb.shape[1], rgb.shape[2], device=dev, dtype=rgb.dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        spatial.halo_exchange(x, 3, space)
    torch.cuda.synchronize()
    return {'forward': events[0].elapsed_time(events[1]) / iters, 'peak': peak,
            'exchange_32ch_p3': (time.perf_counter() - t0) * 1e3 / iters}


def spatial_step(space):
    return lambda task: make_spatial_train_step(task, space)


def step_gaps(got, want):
    """A spatial step's outcome against the plain step's (``step_outcome``)
    -> the loss's relative error, the worst gradient error over its tensor's
    largest |gradient|, the running statistics' worst error over their
    tolerance; asserts loss rtol 1e-5, gradients ``GRAD_RTOL`` (a tensor
    whose largest |gradient| is below 1e-5 of the network's vanishes
    analytically: held within 1e-5 of that), statistics rtol 1e-4, atol
    1e-6."""
    loss = abs(got['loss'] - want[0]) / abs(want[0])
    assert loss <= 1e-5, (got['loss'], want[0])
    top = max(float(g.abs().max()) for g in want[1].values())
    worst_grad = 0.0
    for name, w in want[1].items():
        scale = float(w.abs().max())
        err = float((got['grads'][name] - w).abs().max())
        if scale < 1e-5 * top:
            assert err <= 1e-5 * top, f'gradient {name}: {err}'
            continue
        assert err <= GRAD_RTOL * scale, f'gradient {name}: {err} > {GRAD_RTOL * scale}'
        worst_grad = max(worst_grad, err / scale)
    worst_stats = 0.0
    for name, w in want[2].items():
        if name.endswith(('running_mean', 'running_var')):
            g = got['state'][name]
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6,
                                       msg=lambda m, name=name: f'{name}: {m}')
            worst_stats = max(worst_stats, float(((g - w).abs() / (1e-6 + 1e-4 * w.abs())
                                                  ).max()))
    return {'loss': loss, 'grad': worst_grad, 'stats': worst_stats}


def forward_gap(got, want):
    """The worst |error| of 4 inverse depths, asserting rtol 1e-4, atol
    1e-5 at each scale."""
    for scale, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-4, atol=1e-5,
                                   msg=lambda m, scale=scale: f'scale {scale}: {m}')
    return max(float((g.cpu() - w.cpu()).abs().max()) for g, w in zip(got, want))


def small_card_inputs(dev):
    """[2,128,96] rgb and 95 %-sparse LiDAR on ``dev``, and the seeded
    (16,)*6 network's unsharded forward of them."""
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(2, 128, 96, 3).astype(np.float32)).to(dev)
    lidar = torch.from_numpy((rng.rand(2, 128, 96, 1) * 80 * (rng.rand(2, 128, 96, 1) > 0.95)
                              ).astype(np.float32)).to(dev)
    net = serve.build(CHANNELS, device=dev, seed=1)
    with torch.no_grad():
        want = net(rgb, lidar)['inv_depths']
    return net, rgb, lidar, want


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_space_of_one_on_card_matches_plain_forward(cuda_card, tmp_path):
    dist.init_process_group('nccl', init_method=f'file://{tmp_path / "store"}',
                            rank=0, world_size=1)
    try:
        net, rgb, lidar, want = small_card_inputs(cuda_card)
        got, counts = sharded_forward(net, spatial.Space(1), rgb, lidar)
        forward_gap(got, want)
        assert counts['exchange'] > 0 and counts['statistics'] == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_plain(cuda_card, tmp_path):
    ranks = start_ranks([(card_pair_job, {})], 2, str(tmp_path))
    _, _, _, want = small_card_inputs(cuda_card)
    plain = step_outcome(train_config(), synthetic_batch(np.random.RandomState(0), 2, 128, 64),
                         cuda_card)
    for res in ranks.result(0):
        forward_gap(res['small_forward'], want)
        step_gaps(res['small_step'], plain)
