"""The 4-channel ``rgb_edge`` input through the port's ``cli.infer_edges``
(``main(..., device='cpu')``) against the JAX package's CLI on the same
split and the same JAX-format checkpoint: unsharded, and ``--spatial 2``
and ``--dp 2`` over two gloo ranks spawned by
``tests/test_torch_dp_cuda.start_ranks``.

The split's 6th column is the ``rgb_edge`` map, read as the JAX CLI reads
it (``infer_edges.py:99-110``): ``.npy`` for two frames, a PNG's channel 0
/ 255 for the third.  PackNet-SAN 1A, ``input_channels`` 4, channels
(16,)*6, LiDAR 95 % empty, 64x96, 3 frames at batch 2 (a ragged last
batch), the maps drawn in [0.2, 1] so that scale 0's multiply keeps the
depth finite.  Tolerance rtol 1e-4, atol 1e-5 on every ``_regular.npy``
(``--wire f32``): the network's fp32 tolerance
(tests/test_torch_packnet_variants.py), the depth being its inverse.
"""

import types

import numpy as np
import jax
import optax
import pytest
import torch

from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.training.checkpoint import save_checkpoint
from mindtheedge_tpu.training.state import split_variables
from mindtheedge_tpu_torch.cli import infer_edges
from tests.test_torch_blocks import perturb
from tests.test_torch_dp_cuda import infer_job, start_ranks
from tests.test_torch_tasks import model_config

torch.set_num_threads(1)

H, W, N, BATCH = 64, 96, 3, 2


def write_split(root):
    """RGB and LiDAR PNGs, and the ``rgb_edge`` maps (.npy, .npy, PNG)."""
    import cv2
    rng = np.random.RandomState(0)
    root.mkdir()
    lines = []
    for i in range(N):
        rp, lp = str(root / f'{i}_rgb.png'), str(root / f'{i}_lidar.png')
        cv2.imwrite(rp, rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
        d = (rng.rand(H, W) * 60.0 * 256.0).astype(np.uint16)
        d[rng.rand(H, W) < 0.95] = 0
        cv2.imwrite(lp, d)
        edge = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
        if i < 2:
            ep = str(root / f'{i}_edge.npy')
            np.save(ep, edge)
        else:
            ep = str(root / f'{i}_edge.png')
            cv2.imwrite(ep, np.stack([np.round(edge * 255)] * 3, -1).astype(np.uint8))
        lines.append(f'{rp} None None {lp} None {ep} None None\n')
    split = root / 'split.txt'
    split.write_text(''.join(lines))
    return str(split)


def write_checkpoint(path):
    """The JAX task's 4-channel network, perturbed, saved by the JAX
    package's ``save_checkpoint``."""
    cfg = model_config('SemiSupEdgeModel')
    cfg.model.depth_net.input_channels = 4
    jtask = jtasks.build_task(cfg)
    sample = {'rgb': np.zeros((1, H, W, 3), np.float32),
              'input_depth': np.zeros((1, H, W, 1), np.float32),
              'rgb_edge': np.ones((1, H, W, 1), np.float32)}
    variables = jax.jit(jtask.init)(jax.random.PRNGKey(0), sample)
    variables = {'depth': perturb(jax.tree_util.tree_map(np.asarray, variables['depth']),
                                  np.random.RandomState(0))}
    params, stats = split_variables(variables)
    state = types.SimpleNamespace(
        epoch=1, step=1, params=params, batch_stats=stats,
        opt_state=jax.tree_util.tree_map(np.asarray, optax.adam(1e-3).init(params)))
    save_checkpoint(str(path), cfg, state)


def argv(tmp, split, name, *extra):
    import yaml
    cfg = {
        'model': {'name': 'SemiSupEdgeModel',
                  'depth_net': {'name': 'PackNetSAN01', 'version': '1A', 'input_channels': 4,
                                'channels': [16] * 6}},
        'datasets': {'augmentation': {'image_shape': [H, W]},
                     'test': {'dataset': ['GTA'], 'path': [''], 'split': [split],
                              'input_depth_type': ['lidar'],
                              'depth_type': ['groundtruth']}},
        'save': {'folder': str(tmp / name)},
        'checkpoint': {'filepath': str(tmp / 'edge4.ckpt')},
        'analysis': {'run_metrics': False, 'run_heavy_edge_metrics': False},
    }
    path = tmp / f'{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return ['--config', str(path), '--batch', str(BATCH), '--wire', 'f32', *extra]


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The two ranks' ``--spatial 2`` and ``--dp 2`` runs, started first;
    meanwhile the JAX CLI and the port's unsharded one."""
    from mindtheedge_tpu.cli.infer_edges import main as jax_main
    tmp = tmp_path_factory.mktemp('rgb_edge')
    split = write_split(tmp / 'data')
    write_checkpoint(tmp / 'edge4.ckpt')
    ranks = start_ranks([(infer_job, {'argv': argv(tmp, split, 'spatial', '--spatial', '2')}),
                         (infer_job, {'argv': argv(tmp, split, 'dp', '--dp', '2')})],
                        2, str(tmp / 'ranks'))
    try:
        jax_main(argv(tmp, split, 'jax'))
        infer_edges.main(argv(tmp, split, 'plain'), device='cpu')
        ranks.result(0)
        ranks.result(1)
    finally:
        ranks.join()
    return tmp


def load(folder):
    return [np.load(folder / f'{i:08d}_regular.npy') for i in range(N)]


@pytest.mark.parametrize('name', ['plain', 'spatial', 'dp'])
def test_rgb_edge_depth_matches_jax_cli(runs, name):
    want = load(runs / 'jax')
    for i, (got, w) in enumerate(zip(load(runs / name), want)):
        assert got.shape == w.shape == (H, W) and np.isfinite(got).all()
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5, err_msg=f'frame {i}')


def test_rgb_edge_column_is_read():
    """``_read_inputs`` returns the 6th column as [H,W,1] for a 4-channel
    network and None for a 3-channel one."""
    import tempfile
    from pathlib import Path
    from mindtheedge_tpu_torch import config
    with tempfile.TemporaryDirectory() as d:
        split = write_split(Path(d) / 'data')
        line = open(split).read().splitlines()[2]
        cfg = config.get_cfg_defaults()
        cfg.datasets.test.input_depth_type = ['lidar']
        assert infer_edges._read_inputs(line, cfg, (H, W))[2] is None
        cfg.model.depth_net.input_channels = 4
        rgb, lidar, edge = infer_edges._read_inputs(line, cfg, (H, W))
        assert rgb.shape == (H, W, 3) and lidar.shape == edge.shape == (H, W, 1)
        assert edge.dtype == np.float32 and 0.19 <= edge.min() and edge.max() <= 1.0
