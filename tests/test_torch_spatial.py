"""The port's spatial sharding (``parallel/spatial.py``) on the CPU against
the JAX package: 4 ranks over gloo, spawned from this process by
``tests/test_torch_dp_cuda.start_ranks`` with the JAX-free jobs of
``tests/test_torch_spatial_cuda.py``; the JAX oracle runs here while they
work.  Training is in ``tests/test_torch_spatial_train.py``.

* ``legal_space_sizes``, ``max_space_devices`` and ``legal_space_grids``
  equal the JAX package's for H, W in {64, 128, 384, 1216, 1936}.
* ``halo_exchange`` in H (over 4), W (over 4) and H x W (2 x 2) for halos
  1, 2, 3: each rank's exchanged block equals the zero-padded frame's
  slice and JAX's ``halo_exchange_h`` under ``shard_map`` on the virtual
  CPU devices, bit for bit; its backward equals the gradient of the zero
  pad (the cotangents of every rank summed onto the frame), within fp32
  rounding of those sums.
* PackNet-SAN 1A at channels (16,)*6 with the SAN branch and 95 %-sparse
  LiDAR, the JAX weights carried over by ``state_dict_from_jax``: H over 4
  at [1,128,96], W over 2 at [1,32,128], 2 x 2 at [1,64,128]; the gathered
  inverse depths against JAX's forward within rtol 1e-4, atol 1e-5 at the
  4 scales.
* On ``tests/make_synthetic_dataset``'s blocky frames (near-constant
  grey blocks) the seeded network's fp32 forward is ill-conditioned, and
  the port's unsharded forward on the CPU lies 2e-4 (relative) off its
  own fp64 forward there, from ``F.group_norm``'s fp32 statistics (ROADMAP
  Queue 3, L2); the sharded forward, H over 4 at [4,128,128], must lie
  within 3e-5 of the fp64 forward (measured 7e-6 to 1.1e-5), closer than
  the unsharded one.
* ``infer_edges --spatial -1 --wire f32`` (4 row blocks) and ``--spatial
  2x2`` on the 4 ranks against the port's unsharded CLI in this process:
  every depth map within rtol 1e-4, atol 1e-5.  The split's RGB is white
  noise (uint8), as the JAX package's ``tests/test_cli_spatial.py`` draws
  it, with the synthetic split's LiDAR: on its blocky frames the two runs
  differ by the unsharded forward's own error (above).  ``--spatial 3``
  exits with the legal sizes and ``--spatial 2`` in one process exits
  naming the launch, both before any work.
* bf16: the sharded forward (H over 4, 2 x 2) against the JAX package's
  sharded bf16 on the virtual devices and against the port's unsharded
  bf16, and ``infer_edges --spatial 2`` at ``arch.precision: bfloat16``
  against the unsharded bf16 CLI, each within tests/test_torch_bf16.py's
  band (2x the bf16-vs-fp32 gap).
* What is refused rather than run otherwise: W in the training step (the
  JAX step shards H only), a network without spatial blocks, a grid the
  processes do not fill.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from mindtheedge_tpu.models.packnet import PackNetSAN as JaxPackNetSAN
from mindtheedge_tpu.parallel import spatial as jspatial
from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.cli import infer_edges
from mindtheedge_tpu_torch.models.resnet import DepthResNet
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.parallel.mesh import make_spatial_train_step
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.make_synthetic_dataset import make_dataset
from tests.test_torch_blocks import perturb
from tests.test_torch_dp import infer_argv
from tests.test_torch_dp_cuda import infer_job, start_ranks
from tests.test_torch_bf16 import BAND, rel_err, within_band
from tests.test_torch_spatial_cuda import (
    CHANNELS, HALO_GRIDS, forward_job, fp64_job, halo_cotangent, halo_job, load_net)

torch.set_num_threads(1)

WORLD = 4
HALO_X = np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32)   # NCHW
FORWARD_CASES = {'h4': ((4, None), (1, 128, 96)), 'w2': ((None, 2), (1, 32, 128)),
                 'hw2x2': ((2, 2), (1, 64, 128))}
BF16_CASES = ('h4', 'hw2x2')
CLI_FRAMES, CLI_SHAPE = 6, (128, 128)


def frames(shape, seed):
    """rgb and 95 %-sparse LiDAR (NHWC numpy) of ``shape`` (B, H, W)."""
    rng = np.random.RandomState(seed)
    b, h, w = shape
    lidar = rng.rand(b, h, w, 1).astype(np.float32) * 80.0
    lidar[rng.rand(b, h, w, 1) < 0.95] = 0.0
    return rng.rand(b, h, w, 3).astype(np.float32), lidar


def noise_split(root):
    """``make_dataset``'s split at ``CLI_SHAPE`` with white-noise RGB."""
    import cv2
    split = make_dataset(str(root), n=CLI_FRAMES, h=CLI_SHAPE[0], w=CLI_SHAPE[1])
    rng = np.random.RandomState(7)
    with open(split) as f:
        for line in f.read().splitlines():
            cv2.imwrite(line.split(' ')[0], rng.randint(0, 256, CLI_SHAPE + (3,), np.uint8))
    return split


def cli_argv(tmp, split, name, spatial_arg, precision='float32'):
    """``tests/test_torch_dp.infer_argv``'s run (the (16,)*6 network, random
    weights, f32 wire) at ``CLI_SHAPE`` with ``--spatial spatial_arg``, at
    ``arch.precision`` ``precision``."""
    import yaml
    argv = infer_argv(tmp, split, name, dp=-1)
    with open(argv[1]) as f:
        cfg = yaml.safe_load(f)
    cfg['datasets']['augmentation']['image_shape'] = list(CLI_SHAPE)
    cfg['arch'] = {'precision': precision}
    with open(argv[1], 'w') as f:
        yaml.safe_dump(cfg, f)
    return argv + ['--spatial', spatial_arg]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The ranks' jobs, started first; meanwhile the JAX network's weights
    (written for the ranks before they need them), JAX's forwards and halo
    exchanges, and the unsharded CLI."""
    tmp = tmp_path_factory.mktemp('spatial')
    jmodel = JaxPackNetSAN(version='1A', channels=CHANNELS)
    rgb, lidar = frames((1, 64, 128), 0)
    variables = jax.jit(lambda k, r, d: jmodel.init(k, r, d, train=False))(
        jax.random.PRNGKey(0), rgb, lidar)
    variables = perturb(jax.tree_util.tree_map(np.asarray, variables),
                        np.random.RandomState(1))
    torch.save(state_dict_from_jax(variables['params'], variables['batch_stats']),
               tmp / 'weights.pt')
    cases = {name: (grid,) + frames(shape, i) for i, (name, (grid, shape))
             in enumerate(FORWARD_CASES.items())}
    split = noise_split(tmp / 'synth')
    jobs = [(halo_job, {'x': HALO_X}),
            (forward_job, {'weights': str(tmp / 'weights.pt'), 'cases': cases}),
            (infer_job, {'argv': cli_argv(tmp, split, 'rows', '-1')}),
            (infer_job, {'argv': cli_argv(tmp, split, 'grid', '2x2')}),
            (fp64_job, {'grid': (4, None), 'shape': (4, 128, 128)}),
            (forward_job, {'weights': str(tmp / 'weights.pt'), 'dtype': torch.bfloat16,
                           'cases': {k: cases[k] for k in BF16_CASES}}),
            (infer_job, {'argv': cli_argv(tmp, split, 'rows16', '2', 'bfloat16')})]
    ranks = start_ranks(jobs, WORLD, str(tmp / 'ranks'))
    try:
        apply = jax.jit(lambda v, r, d: jmodel.apply(v, r, d, train=False)['inv_depths'])
        want = {name: [np.asarray(d) for d in apply(variables, rgb_, lidar_)]
                for name, (_, rgb_, lidar_) in cases.items()}
        jax_halos = {f'{grid}/{p}': jax_halo(grid, p) for grid in HALO_GRIDS
                     for p in (1, 2, 3)}
        want16 = {name: jax_sharded_bf16(jmodel, variables, *cases[name]) for name in BF16_CASES}
        net16 = load_net(str(tmp / 'weights.pt')).to(torch.bfloat16)
        with torch.no_grad():
            plain16 = {name: [d.float().numpy() for d in net16(
                torch.from_numpy(cases[name][1]).bfloat16(),
                torch.from_numpy(cases[name][2]).bfloat16())['inv_depths']]
                for name in BF16_CASES}
        infer_edges.main(cli_argv(tmp, split, 'plain', '0'), device='cpu')
        infer_edges.main(cli_argv(tmp, split, 'plain16', '0', 'bfloat16'), device='cpu')
        ranks.join()
    except BaseException:
        ranks.join()
        raise
    return {'ranks': ranks, 'tmp': tmp, 'split': split, 'want': want, 'jax_halos': jax_halos,
            'want16': want16, 'plain16': plain16}


def jax_sharded_bf16(jmodel, variables, grid, rgb, lidar):
    """The JAX package's sharded forward of ``jmodel`` on ``grid`` of the
    virtual CPU devices, in bf16 as its ``run_depth`` runs it (the
    variables and inputs cast to bf16, the outputs back to fp32) -> 4
    inverse depths, NHWC numpy."""
    n_h, n_w = grid[0] or 1, grid[1] or 1
    mesh = Mesh(np.asarray(jax.devices()[:n_h * n_w]).reshape(n_h, n_w), ('space', 'space_w'))
    axis = ('space', 'space_w') if grid[1] else 'space'
    infer = jspatial.make_spatial_infer(jmodel.clone(spatial_axis=axis), mesh, 'space',
                                        with_depth=True,
                                        w_axis_name='space_w' if grid[1] else None)
    cast = lambda t: jnp.asarray(t).astype(jnp.bfloat16)
    out = infer(jax.tree_util.tree_map(cast, variables), cast(rgb), cast(lidar))
    return [np.asarray(d.astype(jnp.float32)) for d in out]


def jax_halo(grid, p):
    """JAX's ``halo_exchange_h`` of ``HALO_X`` on a mesh of ``grid`` ->
    {rank: its exchanged block, NCHW}."""
    n_h, n_w = grid[0] or 1, grid[1] or 1
    axes = ('space' if grid[0] else None, 'space_w' if grid[1] else None)
    mesh = Mesh(np.asarray(jax.devices()[:n_h * n_w]).reshape(n_h, n_w), ('space', 'space_w'))
    spec = P(None, 'space', 'space_w')
    out = np.asarray(jax.jit(jax.shard_map(
        lambda x: jspatial.halo_exchange_h(x, p, axes), mesh=mesh, in_specs=spec,
        out_specs=spec, check_vma=False))(jnp.asarray(HALO_X.transpose(0, 2, 3, 1))))
    hb, wb = out.shape[1] // n_h, out.shape[2] // n_w
    return {h * n_w + w: out[:, h * hb:(h + 1) * hb, w * wb:(w + 1) * wb].transpose(0, 3, 1, 2)
            for h in range(n_h) for w in range(n_w)}


def zero_pad_halos(grid, p):
    """The exchanged blocks the zero-padded frame gives, and the gradient
    of sum(block * cotangent) over every rank -> ({rank: block},
    {rank: its share of the gradient})."""
    n_h, n_w = grid[0] or 1, grid[1] or 1
    ph, pw = (p if grid[0] else 0), (p if grid[1] else 0)
    b, c, h, w = HALO_X.shape
    hl, wl = h // n_h, w // n_w
    padded = np.pad(HALO_X, ((0, 0), (0, 0), (p, p), (p, p)))
    canvas = np.zeros(padded.shape, np.float64)
    blocks, grads = {}, {}
    for r in range(n_h * n_w):
        i, j = divmod(r, n_w)
        rows = slice(p + i * hl - ph, p + (i + 1) * hl + ph)
        cols = slice(p + j * wl - pw, p + (j + 1) * wl + pw)
        blocks[r] = padded[:, :, rows, cols]
        canvas[:, :, rows, cols] += halo_cotangent(r, blocks[r].shape).numpy()
    inner = canvas[:, :, p:p + h, p:p + w]
    for r in range(n_h * n_w):
        i, j = divmod(r, n_w)
        grads[r] = inner[:, :, i * hl:(i + 1) * hl, j * wl:(j + 1) * wl]
    return blocks, grads


@pytest.mark.parametrize('height', [64, 128, 384, 1216, 1936])
@pytest.mark.parametrize('width', [64, 128, 384, 1216, 1936])
def test_legal_sizes_match_jax(height, width):
    for limit in (1, 2, 4, 8):
        assert spatial.legal_space_sizes(height, limit=limit) == \
            jspatial.legal_space_sizes(height, limit=limit)
        assert spatial.max_space_devices(height, limit=limit) == \
            jspatial.max_space_devices(height, limit=limit)
        assert spatial.legal_space_grids(height, width, limit=limit) == \
            jspatial.legal_space_grids(height, width, limit=limit)


@pytest.mark.parametrize('grid', HALO_GRIDS, ids=['h4', 'w4', 'hw2x2'])
@pytest.mark.parametrize('p', [1, 2, 3])
def test_halo_exchange_matches_zero_pad_and_jax(runs, grid, p):
    blocks, grads = zero_pad_halos(grid, p)
    for r, res in enumerate(runs['ranks'].result(0)):
        got, grad = res[f'{grid}/{p}']
        np.testing.assert_array_equal(got.numpy(), blocks[r], err_msg=f'rank {r}')
        np.testing.assert_array_equal(got.numpy(), runs['jax_halos'][f'{grid}/{p}'][r],
                                      err_msg=f'rank {r} against JAX')
        np.testing.assert_allclose(grad.numpy(), grads[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f'rank {r} gradient')


@pytest.mark.parametrize('name', list(FORWARD_CASES))
def test_sharded_forward_matches_jax(runs, name):
    results = runs['ranks'].result(1)
    got = results[0][name]
    assert all(res[name] is True for res in results[1:])
    for scale, (g, w) in enumerate(zip(got, runs['want'][name])):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=f'{name} scale {scale}')


@pytest.mark.parametrize('name', BF16_CASES)
def test_sharded_bf16_forward_within_band(runs, name):
    """bf16 through the spatial seams: the port's sharded bf16 forward
    against the JAX package's sharded bf16 and against the port's own
    unsharded bf16, each within ``BAND`` times JAX's sharded bf16 gap to
    its fp32 forward (tests/test_torch_bf16.py's band), at every scale."""
    results = runs['ranks'].result(5)
    assert all(res[name] is True for res in results[1:])
    for s, (got, j16, p16, j32) in enumerate(zip(results[0][name], runs['want16'][name],
                                                 runs['plain16'][name], runs['want'][name])):
        assert got.dtype == torch.bfloat16 and got.shape == j16.shape
        got = got.float().numpy()
        gap = rel_err(j16, j32)
        print(f'{name} scale {s}: JAX sharded bf16 vs fp32 {gap}, port sharded bf16 vs JAX '
              f'{rel_err(got, j16)}, vs the port unsharded bf16 {rel_err(got, p16)}')
        within_band(f'{name} scale {s} against JAX', rel_err(got, j16), gap)
        within_band(f'{name} scale {s} against unsharded', rel_err(got, p16), gap)


def test_infer_edges_spatial_bf16_within_band(runs):
    """``infer_edges --spatial 2`` (2 data x 2 row blocks) at
    ``arch.precision: bfloat16`` against the unsharded bf16 CLI, within
    ``BAND`` times the unsharded CLI's own bf16-vs-fp32 gap."""
    runs['ranks'].result(6)
    out, plain16, plain = (runs['tmp'] / n for n in ('rows16', 'plain16', 'plain'))
    for i in range(CLI_FRAMES):
        got, want, want32 = (np.load(d / f'{i:08d}_regular.npy') for d in (out, plain16, plain))
        assert got.shape == want.shape == CLI_SHAPE
        gap = rel_err(want, want32)
        assert gap[1] > 0, 'the bf16 CLI ran in fp32'
        within_band(f'frame {i}', rel_err(got, want), gap)


def test_sharded_forward_on_blocky_frames_is_closer_to_fp64(runs):
    for r, res in enumerate(runs['ranks'].result(4)):
        for scale, (got, plain) in enumerate(zip(res['sharded'], res['plain'])):
            assert got <= 3e-5 and got <= plain, (r, scale, got, plain)


@pytest.mark.parametrize('job,name', [(2, 'rows'), (3, 'grid')])
def test_infer_edges_spatial_matches_unsharded(runs, job, name):
    runs['ranks'].result(job)
    out, plain = runs['tmp'] / name, runs['tmp'] / 'plain'
    assert (out / 'pred_list.txt').read_text() == \
        (plain / 'pred_list.txt').read_text().replace('/plain/', f'/{name}/')
    for i in range(CLI_FRAMES):
        got = np.load(out / f'{i:08d}_regular.npy')
        want = np.load(plain / f'{i:08d}_regular.npy')
        assert got.shape == want.shape == CLI_SHAPE
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f'frame {i}')


def test_infer_edges_spatial_refusals(runs):
    split = runs['split']
    with pytest.raises(SystemExit, match=r'--spatial 3 is illegal .* Legal mesh sizes for '
                                         r'H=128: \[1, 2, 4\]'):
        infer_edges.main(cli_argv(runs['tmp'], split, 'illegal', '3'), device='cpu')
    with pytest.raises(SystemExit, match=r'--spatial 3x2 is illegal'):
        infer_edges.main(cli_argv(runs['tmp'], split, 'illegal', '3x2'), device='cpu')
    with pytest.raises(SystemExit, match=r'--dp 1 x --spatial 2 needs 2 processes.*'
                                         r'torchrun --nproc_per_node 2'):
        infer_edges.main(cli_argv(runs['tmp'], split, 'alone', '2'), device='cpu')
    assert not (runs['tmp'] / 'illegal').exists() and not (runs['tmp'] / 'alone').exists()


def test_spatial_refusals():
    net = serve.build(CHANNELS, device='cpu', seed=0)
    with pytest.raises(ValueError, match='has no spatial support'):
        spatial.shard_network(DepthResNet(), spatial.Space(1))
    with pytest.raises(ValueError, match='do not divide 1 process'):
        spatial.Space(2)

    class Task:
        depth_net = net
    with pytest.raises(NotImplementedError, match='shards H only'):
        make_spatial_train_step(Task(), spatial.Space(None, 1))
