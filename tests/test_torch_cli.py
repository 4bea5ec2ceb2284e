"""The port's two inference CLIs (mindtheedge_tpu_torch/cli) through
``main(..., device='cpu')`` on a synthetic split, against the JAX package's
CLIs on the same files and the same JAX-format checkpoint.

Fixtures are written as in tests/test_cli_annotate.py and
tests/test_cli_wire.py: cv2-written RGB PNGs and KITTI-style uint16 LiDAR
PNGs at 64x96, 3 frames, batch 2 (so the last batch is ragged), channels
(16,)*6.

Tolerances.  Annotation: the edge maps go through NMS and hysteresis, which
compare values that the two networks compute to rtol 1e-3, so a near-tie
can flip a pixel: per scale >= 99.5 % of pixels within 1e-4.  Normals:
within circular distance 1 on >= 99.9 % of pixels (codes 0 and 255 are
the same angle; see tests/test_torch_edge_ops.py), the 4 corners of each
map left out.  The split file and ``pred_list.txt`` are byte-identical
once the output folder's name is swapped (each CLI writes its own).
Inference: ``_regular.npy`` depths within 1/256 m, one u16 step.
"""

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.cli import infer_edge_estimation, infer_edges
from tests.test_torch_annotate_cuda import normals_within_one_code
from tests.test_torch_tasks import write_jax_checkpoint

torch.set_num_threads(1)

H, W, N, BATCH = 64, 96, 3, 2


def write_split(tmp_path):
    import cv2
    rng = np.random.RandomState(0)
    (tmp_path / 'rgb').mkdir()
    (tmp_path / 'lidar').mkdir()
    lines = []
    for i in range(N):
        rp = str(tmp_path / 'rgb' / f'{i:06d}.png')
        cv2.imwrite(rp, rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
        d = (rng.rand(H, W) * 60.0 * 256.0).astype(np.uint16)
        d[rng.rand(H, W) < 0.95] = 0
        lp = str(tmp_path / 'lidar' / f'{i:06d}.png')
        cv2.imwrite(lp, d)
        lines.append(f'{rp} None None {lp} None None None None\n')
    split = tmp_path / 'split.txt'
    split.write_text(''.join(lines))
    return split


def write_config(path, cfg):
    import yaml
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def run(main, cfg, tmp_path, name, *argv, **kwargs):
    """Write ``cfg`` with its outputs under ``tmp_path/name`` and run
    ``main`` on it -> the output folder."""
    cfg = dict(cfg, save={**cfg['save'], 'folder': str(tmp_path / name)})
    path = write_config(tmp_path / f'{name}.yaml', cfg)
    main(['--config', path, '--batch', str(BATCH), *argv], **kwargs)
    return tmp_path / name


@pytest.fixture(scope='module')
def annotation(tmp_path_factory):
    """The synthetic split, a JAX-format DEE checkpoint and the config."""
    tmp_path = tmp_path_factory.mktemp('annotate')
    split = write_split(tmp_path)
    write_jax_checkpoint(tmp_path / 'dee.ckpt', 'EdgeEstimationLIDARModel')
    cfg = {
        'model': {'name': 'EdgeEstimationLIDARModel',
                  'depth_net': {'name': 'PackNetSAN01', 'version': '1A'}},
        'datasets': {
            'augmentation': {'image_shape': (H, W)},
            'test': {'dataset': ['GTA'], 'path': [''], 'split': [str(split)],
                     'input_depth_type': ['lidar'],
                     'depth_type': ['groundtruth'],
                     'is_infer_lidar': True, 'is_infer_rgb': True,
                     'nms': True, 'hysteresis': True, 'normals': True}},
        'save': {'depth': {'multiscale': True}},
        'checkpoint': {'filepath': str(tmp_path / 'dee.ckpt')},
    }
    return cfg, tmp_path


@pytest.fixture(scope='module')
def port_annotation(annotation):
    return run(infer_edge_estimation.main, *annotation, 'edges', device='cpu')


def test_annotation_artifacts(port_annotation):
    import cv2
    out_dir = port_annotation
    for i in range(N):
        for tag in ('lidar', 'regular'):
            for s in range(4):
                base = f'{i:08d}_{tag}_{s:03d}'
                png = cv2.imread(str(out_dir / f'{base}.png'), cv2.IMREAD_UNCHANGED)
                assert png.dtype == np.uint8 and png.shape == (H >> s, W >> s)
                edge = np.load(out_dir / f'{base}.npy')
                assert edge.dtype == np.float32 and edge.shape == (H >> s, W >> s)
                assert 0.0 <= edge.min() and edge.max() <= 1.0
                normals = cv2.imread(str(out_dir / 'normals' / f'{base}.png'),
                                     cv2.IMREAD_UNCHANGED)
                assert normals.dtype == np.uint8 and normals.shape == (H >> s, W >> s)
    rows = [ln.split(' ') for ln in
            (out_dir / 'rgb_lidar_edges_split.txt').read_text().splitlines()]
    assert len(rows) == N and all(len(r) == 8 for r in rows)
    for i, r in enumerate(rows):
        assert r[0].endswith(f'{i:06d}.png') and r[1] == r[3]
        assert r[2] == f'{out_dir}/{i:08d}_lidar_000.png'
        assert r[7] == f'{out_dir}/normals/{i:08d}_lidar_000.png'


def test_annotation_matches_jax_cli(annotation, port_annotation):
    import cv2
    from mindtheedge_tpu.cli.infer_edge_estimation import main as jax_main
    out_dir = port_annotation
    jax_dir = run(jax_main, *annotation, 'edges_jax')
    split = (jax_dir / 'rgb_lidar_edges_split.txt').read_text()
    assert ((out_dir / 'rgb_lidar_edges_split.txt').read_bytes()
            == split.replace(str(jax_dir), str(out_dir)).encode())
    for i in range(N):
        for tag in ('lidar', 'regular'):
            for s in range(4):
                base = f'{i:08d}_{tag}_{s:03d}'
                got, want = (np.load(d / f'{base}.npy') for d in (out_dir, jax_dir))
                close = np.abs(got - want) <= 1e-4
                assert close.mean() >= 0.995, f'{base}: {close.mean():.4f}'
                got, want = (cv2.imread(str(d / 'normals' / f'{base}.png'),
                                        cv2.IMREAD_UNCHANGED)
                             for d in (out_dir, jax_dir))
                near = normals_within_one_code(got, want)
                assert near >= 0.999, f'{base} normals: {near:.4f}'


@pytest.fixture(scope='module')
def inference(tmp_path_factory):
    """The synthetic split, a JAX-format depth checkpoint and the config."""
    tmp_path = tmp_path_factory.mktemp('infer')
    split = write_split(tmp_path)
    write_jax_checkpoint(tmp_path / 'depth.ckpt', 'SemiSupEdgeModel')
    cfg = {
        'model': {'name': 'SemiSupEdgeModel',
                  'depth_net': {'name': 'PackNetSAN01', 'version': '1A'}},
        'datasets': {
            'augmentation': {'image_shape': (H, W)},
            'test': {'dataset': ['GTA'], 'path': [''], 'split': [str(split)],
                     'input_depth_type': ['lidar'],
                     'depth_type': ['groundtruth']}},
        'save': {},
        'checkpoint': {'filepath': str(tmp_path / 'depth.ckpt')},
        'analysis': {'run_metrics': False, 'run_heavy_edge_metrics': False},
    }
    return cfg, tmp_path


@pytest.fixture(scope='module')
def port_inference(inference):
    return run(infer_edges.main, *inference, 'depth', '--wire', 'u16',
               device='cpu')


def test_inference_artifacts(port_inference):
    import cv2
    out_dir = port_inference
    preds = (out_dir / 'pred_list.txt').read_text().splitlines()
    assert preds == [f'{out_dir}/{i:08d}_regular.npy' for i in range(N)]
    for i in range(N):
        depth = np.load(out_dir / f'{i:08d}_regular.npy')
        assert depth.dtype == np.float32 and depth.shape == (H, W)
        assert np.isfinite(depth).all() and depth.min() >= 0.5
        np.testing.assert_array_equal(depth * 256.0, np.round(depth * 256.0))
        png = cv2.imread(str(out_dir / f'{i:08d}_regular.png'), cv2.IMREAD_UNCHANGED)
        assert png.dtype == np.uint8 and png.shape == (H, W)
        color = cv2.imread(str(out_dir / f'{i:08d}_regular_color.png'),
                           cv2.IMREAD_UNCHANGED)
        assert color.dtype == np.uint8 and color.shape == (H, W, 3)


def test_inference_matches_jax_cli(inference, port_inference):
    from mindtheedge_tpu.cli.infer_edges import main as jax_main
    out_dir = port_inference
    jax_dir = run(jax_main, *inference, 'depth_jax', '--wire', 'u16')
    for i in range(N):
        got, want = (np.load(d / f'{i:08d}_regular.npy') for d in (out_dir, jax_dir))
        assert np.abs(got - want).max() <= 1.0 / 256.0 + 1e-6
    pred_list = (jax_dir / 'pred_list.txt').read_text()
    assert ((out_dir / 'pred_list.txt').read_bytes()
            == pred_list.replace(str(jax_dir), str(out_dir)).encode())


@pytest.mark.parametrize('argv,analysis,slice_name', [
    ([], {'run_metrics': True}, 'Slice D'),
    ([], {'run_heavy_edge_metrics': True}, 'Slice D'),
    (['--spatial', '2'], {}, 'Slice E'),
    (['--dp', '2'], {}, 'Slice E'),
])
def test_inference_refuses_unported_before_work(inference, tmp_path, argv,
                                                analysis, slice_name):
    cfg = dict(inference[0], analysis={**inference[0]['analysis'], **analysis})
    with pytest.raises(SystemExit, match=slice_name):
        run(infer_edges.main, cfg, tmp_path, 'never', *argv, device='cpu')
    assert not (tmp_path / 'never').exists()


def test_inference_sparse_uplink_equals_dense(inference, port_inference):
    """--wire u16 sends the LiDAR as sparse points; --wire f32 sends it
    dense.  The PNG LiDAR is exact at 1/256 m, so the u16 artifact is the
    quantisation of the f32 one (tests/test_cli_wire.py)."""
    f32_dir = run(infer_edges.main, *inference, 'depth_f32', '--wire', 'f32',
                  device='cpu')
    for i in range(N):
        u16 = np.load(port_inference / f'{i:08d}_regular.npy')
        f32 = np.load(f32_dir / f'{i:08d}_regular.npy')
        np.testing.assert_array_equal(
            u16, np.round(np.clip(f32 * 256.0, 0, 65535)).astype(np.float32) / 256.0)
