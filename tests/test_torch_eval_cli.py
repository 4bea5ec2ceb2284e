"""The port's evaluation entry points against the JAX package's: the two
evaluation CLIs (``cli/eval_depth.py``, ``cli/eval_depth_edges.py``),
``cli/infer_edges.run_post_metrics``, and ``cli/infer_edges.main`` with the
depth and edge-AUC metrics on, in one process, on the seeded synthetic GT
trees of tests/test_torch_evaluation.py.

Equal, not close: the CSV bytes, the pickle's contents (the packages'
ConfigNode classes differ, so not its bytes), ``edge_AUC.txt``, the Canny
JPEGs and the printed numbers.  One exception: ``infer_edges.main`` end to
end, where each package runs its own network on a 4-frame split from one
JAX-written checkpoint.  Their u16 depth maps differ by up to one code,
1/256 m (tests/test_torch_cli.py), which moves a pixel of the protocol's
80/255 m uint8 grid where a depth lies within 1/256 m of a step of that
grid, and so a Canny edge; there the AUCs are held within 0.02 (measured:
see the test), and the metrics are then compared exactly by running the
JAX package's ``run_post_metrics`` on the port's own ``.npy`` files.
"""

import contextlib
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.cli import eval_depth as jeval_depth
from mindtheedge_tpu.cli import eval_depth_edges as jeval_depth_edges
from mindtheedge_tpu.cli import infer_edges as jinfer_edges
from mindtheedge_tpu_torch import config
from mindtheedge_tpu_torch.cli import eval_depth, eval_depth_edges, infer_edges
from tests.test_torch_cli import run
from tests.test_torch_evaluation import (
    DDAD_GT, DDAD_PRED, KITTI_CROP, KITTI_GT, KITTI_PRED, blocky_depth, write_gt_tree,
    write_list)
from tests.test_torch_tasks import write_jax_checkpoint

torch.set_num_threads(1)

NUMBER = re.compile(r'-?\d+\.\d+(?:e-?\d+)?|nan')


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
    return write_gt_tree(str(tmp_path_factory.mktemp('kitti')), 3, KITTI_GT, KITTI_PRED)


@pytest.fixture(scope='module')
def ddad(tmp_path_factory):
    return write_gt_tree(str(tmp_path_factory.mktemp('ddad')), 4, DDAD_GT, DDAD_PRED, seed=2)


@contextlib.contextmanager
def serial(monkeypatch):
    """A context in which the JAX package's ``pr_evaluation`` (4 workers in
    ``run_post_metrics``) matches in one process: it forks its pool, and
    forking a process that runs JAX's threads can deadlock."""
    with monkeypatch.context() as m:
        m.setattr(os, 'cpu_count', lambda: 1)
        yield


def pickles_equal(a, b):
    with open(a, 'rb') as f:
        got = pickle.load(f)
    with open(b, 'rb') as f:
        want = pickle.load(f)
    assert got['columns'] == want['columns']
    np.testing.assert_array_equal(got['per_frm_res'], want['per_frm_res'])
    assert got['analysis_cfg'] == want['analysis_cfg']


@pytest.mark.parametrize('argv', [[], ['--median_scaling', 'median', '--gt_crop', '0', '1242',
                                       '0', '375']])
def test_eval_depth_cli_equals_jax(kitti, tmp_path, capsys, argv):
    """The files equal; the printed means are the CSV's numbers, and agree
    with pandas' print of the JAX CLI to its 6 decimals."""
    gts, _, preds = kitti
    lists = ['--image_list', write_list(tmp_path / 'im.txt', gts),
             '--gt_list', write_list(tmp_path / 'gt.txt', gts),
             '--pred_list', write_list(tmp_path / 'pred.txt', preds)]
    eval_depth.main(lists + argv + ['--out_dir', str(tmp_path / 'port')])
    port_out = capsys.readouterr().out
    jeval_depth.main(lists + argv + ['--out_dir', str(tmp_path / 'jax')])
    jax_out = capsys.readouterr().out
    csv = (tmp_path / 'port' / 'mean_frames_depth_metrics.csv').read_text()
    assert csv == (tmp_path / 'jax' / 'mean_frames_depth_metrics.csv').read_text()
    pickles_equal(tmp_path / 'port' / 'analyzer_data.pkl', tmp_path / 'jax' / 'analyzer_data.pkl')
    values = [line.split(',')[1] for line in csv.splitlines()[1:]]
    swap = lambda line: line.replace(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    assert port_out.splitlines()[0] == swap(jax_out.splitlines()[0])
    printed = [line.split()[1] for line in port_out.splitlines()[1:1 + len(values)]]
    assert printed == values and len(values) == 7
    jax_printed = [float(line.split()[1]) for line in jax_out.splitlines()[1:8]]
    np.testing.assert_allclose([float(v) for v in values], jax_printed, rtol=0, atol=5e-7)
    assert port_out.splitlines()[-1] == swap(jax_out.splitlines()[-1])


@pytest.mark.parametrize('workers', [1, 2])
def test_eval_depth_edges_cli_equals_jax(kitti, tmp_path, capsys, monkeypatch, workers):
    """The same lists, arguments and prints (the CLI crops as KITTI-DE), the
    port on 1 and on 2 workers, the JAX CLI in one process."""
    _, edges, preds = kitti
    pred_list = write_list(tmp_path / 'pred_list.txt', [p.split('/')[-1] for p in preds])
    gt_list = write_list(tmp_path / 'gt_list.txt', [p.split('/')[-1] for p in edges])
    argv = ['--depth_pred_list_path', pred_list, '--depth_pred_dir_path', preds[0].rsplit('/', 1)[0],
            '--depth_edge_gt_list_path', gt_list, '--depth_edge_gt_dir_path',
            edges[0].rsplit('/', 1)[0], '--num_workers', str(workers),
            '--prec_recall_eval_range_min', '0.14', '--prec_recall_eval_range_max', '0.37']
    got = eval_depth_edges.main(argv + ['--temp_save_path', str(tmp_path / 'port')])
    port_out = capsys.readouterr().out
    with serial(monkeypatch):
        want = jeval_depth_edges.main(argv + ['--temp_save_path', str(tmp_path / 'jax')])
    assert got == want and port_out == capsys.readouterr().out
    assert 0.0 < got[0] < 1.0 and 'AUC over partial range: ' in port_out


def analysis_config(gts, edges, gt_crop, **analysis):
    return {'analysis': {'run_metrics': True, 'run_heavy_edge_metrics': True,
                         'gt_image_list': gts, 'edge_image_list': edges,
                         'gt_crop': gt_crop, 'median_scaling': 'none', **analysis}}


def post_metrics(pkg, cfg_dict, folder, pred_files, monkeypatch):
    """``pkg``'s ``run_post_metrics`` with its own config tree, its outputs
    in ``folder``."""
    cfg = pkg.get_cfg_defaults()
    cfg.merge_from_other_cfg(cfg.__class__(cfg_dict))
    cfg.save.folder = str(folder)
    folder.mkdir()
    write_list(folder / 'pred_list.txt', pred_files)
    if pkg is config:
        infer_edges.run_post_metrics(cfg, pred_files)
        return
    with serial(monkeypatch):
        jinfer_edges.run_post_metrics(cfg, pred_files)


def assert_post_metrics_equal(port, jax, analysis):
    for name in ('mean_frames_depth_metrics.csv', 'edge_AUC.txt'):
        if (jax / name).exists():
            assert (port / name).read_bytes() == (jax / name).read_bytes(), name
        else:
            assert not (port / name).exists()
    pkl = 'sfm_analysis/' + analysis.get('out_file_name', 'analyzer_data.pkl')
    if (jax / pkl).exists():
        pickles_equal(port / pkl, jax / pkl)
    jpegs = sorted(p.name for p in (jax / 'temp_output').iterdir())
    assert jpegs == sorted(p.name for p in (port / 'temp_output').iterdir())
    for name in jpegs:
        assert (port / 'temp_output' / name).read_bytes() == \
            (jax / 'temp_output' / name).read_bytes()


@pytest.mark.parametrize('tree,gt_crop,analysis', [
    ('kitti', KITTI_CROP, {}),
    ('kitti', KITTI_CROP, {'median_scaling': 'median', 'min_depth': 1.0,
                           'prec_recall_eval_range_min': 0.29,
                           'out_file_name': 'kitti.pkl'}),
    ('ddad', [], {'run_metrics': False, 'prec_recall_eval_range_min': 0.14,
                  'prec_recall_eval_range_max': 0.37}),
    ('ddad', [], {'start_frm_idx': 1, 'end_frm_idx': 3}),
])
def test_run_post_metrics_equals_jax(request, tmp_path, capsys, monkeypatch, tree, gt_crop,
                                     analysis):
    """The shipped evaluation configs' metrics (``infer_packnet_kitti.yaml``:
    both on, KITTI's crop; ``eval_ddad_de.yaml``: the edge AUC alone, no
    crop, precision range [0.14, 0.37]) on the same prediction files: every
    file and every printed number equal."""
    gts, edges, preds = request.getfixturevalue(tree)
    cfg = analysis_config(write_list(tmp_path / 'gt.txt', gts),
                          write_list(tmp_path / 'edge.txt', edges), gt_crop, **analysis)
    post_metrics(config, cfg, tmp_path / 'port', preds, monkeypatch)
    port_out = capsys.readouterr().out
    post_metrics(jconfig, cfg, tmp_path / 'jax', preds, monkeypatch)
    jax_out = capsys.readouterr().out
    assert_post_metrics_equal(tmp_path / 'port', tmp_path / 'jax', analysis)
    for key in ('D3R ordinal', 'Edge AUC full'):
        got = [ln for ln in port_out.splitlines() if ln.startswith(key)]
        want = [ln for ln in jax_out.splitlines() if ln.startswith(key)]
        assert [NUMBER.findall(g) for g in got] == [NUMBER.findall(w) for w in want]
    assert ('D3R ordinal' in port_out) == analysis.get('run_metrics', True)
    auc = (tmp_path / 'port' / 'edge_AUC.txt').read_text().splitlines()
    assert [ln.split(': ')[0] for ln in auc] == ['AUC over all range', 'AUC over partial range']
    assert 'native matcher' in port_out


SPLIT_SHAPE, IMAGE_SHAPE, N_FRAMES = (60, 90), (64, 96), 4


@pytest.fixture(scope='module')
def evaluation_split(tmp_path_factory):
    """A 4-frame split (RGB shaded by a blocky scene, uint16 LiDAR at 5 %)
    at 60x90 with its GT depth and edges, inferred at 64x96, a JAX-format
    depth checkpoint, and the config with both metrics on."""
    import cv2
    root = tmp_path_factory.mktemp('eval_split')
    gts, edges, _ = write_gt_tree(str(root / 'gt'), N_FRAMES, SPLIT_SHAPE, SPLIT_SHAPE, seed=3)
    rng = np.random.RandomState(3)
    lines = []
    for i in range(N_FRAMES):
        depth = blocky_depth(rng, *SPLIT_SHAPE)
        rgb = np.clip(depth[..., None] * [3, 2, 1] + rng.randn(*SPLIT_SHAPE, 3) * 4, 0, 255)
        rp, lp = str(root / f'{i:04d}_rgb.png'), str(root / f'{i:04d}_lidar.png')
        cv2.imwrite(rp, rgb.astype(np.uint8))
        cv2.imwrite(lp, (np.where(rng.rand(*SPLIT_SHAPE) < 0.05, depth, 0) * 256).astype(np.uint16))
        lines.append(f'{rp} {gts[i]} {edges[i]} {lp} None None None None')
    write_jax_checkpoint(root / 'depth.ckpt', 'SemiSupEdgeModel')
    cfg = {
        'model': {'name': 'SemiSupEdgeModel',
                  'depth_net': {'name': 'PackNetSAN01', 'version': '1A'}},
        'datasets': {
            'augmentation': {'image_shape': IMAGE_SHAPE},
            'test': {'dataset': ['GTA'], 'path': [''],
                     'split': [write_list(root / 'split.txt', lines)],
                     'input_depth_type': ['lidar'], 'depth_type': ['groundtruth']}},
        'save': {},
        'checkpoint': {'filepath': str(root / 'depth.ckpt')},
        **analysis_config(write_list(root / 'gt.txt', gts), write_list(root / 'edge.txt', edges),
                          []),
    }
    return cfg, root


def test_infer_edges_main_with_metrics_equals_jax(evaluation_split, tmp_path, capsys,
                                                  monkeypatch):
    """Inference then the protocol, port vs JAX CLI: the files all there,
    the AUCs within 0.02, and the metrics equal on identical inputs."""
    cfg, _ = evaluation_split
    port = run(infer_edges.main, cfg, tmp_path, 'port', '--wire', 'u16', device='cpu')
    port_out = capsys.readouterr().out
    with serial(monkeypatch):
        jax = run(jinfer_edges.main, cfg, tmp_path, 'jax', '--wire', 'u16')
    capsys.readouterr()
    preds = (port / 'pred_list.txt').read_text().splitlines()
    assert len(preds) == N_FRAMES
    for i in range(N_FRAMES):
        depth = np.load(port / f'{i:08d}_regular.npy')
        assert depth.shape == IMAGE_SHAPE
        assert np.abs(depth - np.load(jax / f'{i:08d}_regular.npy')).max() <= 1 / 256 + 1e-6
    aucs = [[float(ln.split(': ')[1]) for ln in (d / 'edge_AUC.txt').read_text().splitlines()]
            for d in (port, jax)]
    np.testing.assert_allclose(aucs[0], aucs[1], rtol=0, atol=0.02)
    assert all(0.0 <= a <= 1.0 for a in aucs[0])
    assert (port / 'sfm_analysis' / 'analyzer_data.pkl').exists()
    assert len(list((port / 'temp_output').iterdir())) == N_FRAMES
    for key in ('Inference of 4 frames', 'Depth metrics and D3R of 4 frames',
                'Edge AUC of 4 frames at 12 thresholds, native matcher', 'D3R ordinal'):
        assert key in port_out, key

    # the JAX package's metrics on the port's own prediction files
    again = tmp_path / 'jax_on_port'
    again.mkdir()
    shutil.copy(port / 'pred_list.txt', again / 'pred_list.txt')
    jcfg = jconfig.get_cfg_defaults()
    jcfg.merge_from_file(str(tmp_path / 'port.yaml'))
    jcfg.save.folder = str(again)
    with serial(monkeypatch):
        jinfer_edges.run_post_metrics(jcfg, preds)
    assert_post_metrics_equal(port, again, {})
