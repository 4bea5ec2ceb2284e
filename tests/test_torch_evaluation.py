"""The port's evaluation library (mindtheedge_tpu_torch/evaluation, the
Spectral colour map and the item-18 helpers of utils/) against the JAX
package's, in one process, on seeded synthetic inputs.

This is host code: the results must be equal, not close.  Match counts and
maps, thinned maps, PR vectors, AUCs, D3R, per-frame metric rows (NaN where
NaN), CSV bytes and pickle contents are compared exactly; the colour PNG
byte for byte with matplotlib's.

GT trees are blocky depth scenes: KITTI-DE's 375x1242 (its crop
[44, 1197, 153, 371] needs that size) with predictions at the network's
384x1280, so both resizes of the protocol run; and a small DDAD-like shape
with ``gt_crop: []``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from mindtheedge_tpu.config.node import ConfigNode as JConfigNode
from mindtheedge_tpu.evaluation import bsds_matcher as jbm
from mindtheedge_tpu.evaluation import d3r as jd3r
from mindtheedge_tpu.evaluation import depth_analyzer as jda
from mindtheedge_tpu.evaluation import edge_auc as jauc
from mindtheedge_tpu_torch.config.node import ConfigNode
from mindtheedge_tpu_torch.evaluation import bsds_matcher as bm
from mindtheedge_tpu_torch.evaluation import d3r, depth_analyzer as da
from mindtheedge_tpu_torch.evaluation import edge_auc

torch.set_num_threads(1)

KITTI_GT, KITTI_PRED, KITTI_CROP = (375, 1242), (384, 1280), [44, 1197, 153, 371]
DDAD_GT, DDAD_PRED = (90, 150), (96, 160)


def blocky_depth(rng, h, w, boxes=14):
    """[h, w] float64 metres: 40 m with ``boxes`` boxes of 3-75 m."""
    depth = np.full((h, w), 40.0)
    for _ in range(boxes):
        y, x = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
        hh, ww = rng.randint(h // 16, h // 3), rng.randint(w // 16, w // 3)
        depth[y:y + hh, x:x + ww] = rng.uniform(3.0, 75.0)
    return depth


def write_gt_tree(root, n, gt_shape, pred_shape, seed=0, gt_valid=0.3):
    """``n`` frames: GT depth as uint16 PNG (a ``gt_valid`` share of pixels
    set, the rest 0 = invalid), GT edges as a 0/255 PNG (cv2 Canny of the
    scene), and a prediction .npy at ``pred_shape`` (the scene resized,
    boxes moved a few pixels, noise) -> (GT depth, GT edge, prediction
    paths)."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    h, w = gt_shape
    gts, edges, preds = [], [], []
    for i in range(n):
        depth = blocky_depth(rng, h, w)
        gt = np.where(rng.rand(h, w) < gt_valid, depth, 0.0)
        gts.append(os.path.join(root, f'{i:04d}_gt.png'))
        cv2.imwrite(gts[-1], (gt * 256).astype(np.uint16))
        edges.append(os.path.join(root, f'{i:04d}_edge.png'))
        cv2.imwrite(edges[-1], cv2.Canny((depth * 255 / 80).astype(np.uint8), 20, 40))
        pred = cv2.resize(np.roll(depth, (rng.randint(-3, 4), rng.randint(-3, 4)), (0, 1)),
                          pred_shape[::-1], interpolation=cv2.INTER_NEAREST)
        pred = pred * rng.uniform(0.9, 1.1) + rng.randn(*pred_shape) * 0.3
        preds.append(os.path.join(root, f'{i:08d}_regular.npy'))
        np.save(preds[-1], np.maximum(pred, 0.5).astype(np.float32))
    return gts, edges, preds


def write_list(path, items):
    with open(path, 'w') as f:
        f.writelines(p + '\n' for p in items)
    return str(path)


@pytest.fixture(scope='module')
def kitti(tmp_path_factory):
    return write_gt_tree(str(tmp_path_factory.mktemp('kitti')), 3, KITTI_GT, KITTI_PRED)


@pytest.fixture(scope='module')
def ddad(tmp_path_factory):
    return write_gt_tree(str(tmp_path_factory.mktemp('ddad')), 4, DDAD_GT, DDAD_PRED, seed=1)


# -- bsds_matcher ---------------------------------------------------------

def random_map(rng, h=60, w=80, density=0.05):
    return (rng.rand(h, w) < density).astype(np.uint8)


@pytest.mark.parametrize('density,max_dist', [(0.03, 0.002), (0.08, 0.01),
                                              (0.15, 0.01), (0.3, 0.0075)])
def test_correspond_pixels_equals_jax(density, max_dist):
    """Native port vs native JAX: the same library source, the same counts
    and maps; the port's scipy path: the same counts, and the same maps as
    the JAX scipy path."""
    rng = np.random.RandomState(int(density * 100))
    assert bm.backend() == 'native' and jbm._get_lib() is not None
    for h, w in ((60, 80), (120, 97)):
        pred, gt = random_map(rng, h, w, density), random_map(rng, h, w, density)
        got, want = bm.correspond_pixels(pred, gt, max_dist), jbm.correspond_pixels(pred, gt, max_dist)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:] and got[2] > 0
        scipy_got = bm._correspond_pixels_scipy(pred, gt, max_dist)
        scipy_want = jbm._correspond_pixels_scipy(pred, gt, max_dist)
        assert scipy_got[2] == got[2]
        assert scipy_got[0].sum() == got[0].sum() and scipy_got[1].sum() == got[1].sum()
        for a, b in zip(scipy_got, scipy_want):
            np.testing.assert_array_equal(a, b)


def test_correspond_pixels_edge_cases():
    empty = np.zeros((20, 30), np.uint8)
    one = empty.copy()
    one[5, 5] = 1
    for pred, gt in ((empty, one), (one, empty), (empty, empty), (one, one)):
        got, want = bm.correspond_pixels(pred, gt), jbm.correspond_pixels(pred, gt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='shape mismatch'):
        bm.correspond_pixels(empty, empty[:10])


def test_binary_thin_equals_jax():
    rng = np.random.RandomState(4)
    bars = np.zeros((40, 60), np.uint8)
    bars[8:12, 2:50] = 1
    bars[15:35, 20:26] = 1
    blobs = (np.abs(np.fft.ifft2(np.fft.fft2(rng.rand(64, 96))
                                 * (np.hypot(*np.meshgrid(np.fft.fftfreq(96),
                                                          np.fft.fftfreq(64))) < 0.08)))
             > 0.5).astype(np.uint8)
    for img in (bars, blobs, random_map(rng, 50, 70, 0.4)):
        got = bm.binary_thin(img)
        assert got.dtype == bool and got.sum() < img.sum()
        np.testing.assert_array_equal(got, jbm.binary_thin(img))


def test_scipy_path_without_the_library(monkeypatch):
    """Without the library (no g++): correspond_pixels takes the scipy path
    with the same counts, binary_thin raises, as in the JAX binding."""
    rng = np.random.RandomState(5)
    pred, gt = random_map(rng, density=0.1), random_map(rng, density=0.1)
    native = bm.correspond_pixels(pred, gt, 0.01)
    monkeypatch.setattr(bm, '_lib', None)
    monkeypatch.setattr(bm, '_lib_failed', True)
    assert bm.backend() == 'scipy'
    fallback = bm.correspond_pixels(pred, gt, 0.01)
    assert fallback[2] == native[2]
    for a, b in zip(fallback, jbm._correspond_pixels_scipy(pred, gt, 0.01)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match='native matcher'):
        bm.binary_thin(pred)


def test_library_builds_under_build_native(tmp_path, monkeypatch):
    """A build into an empty directory, keyed by the source's hash, from the
    repository's source, which stays as it is."""
    src = bm.SRC.read_bytes()
    assert bm.library_path().parent == bm.ROOT / 'build' / 'native'
    monkeypatch.setattr(bm, 'BUILD_DIR', tmp_path / 'native')
    out = bm.library_path()
    assert out.parent == tmp_path / 'native' and out.name.startswith('libbsds_matcher_')
    bm._build(out)
    assert out.exists() and [p.name for p in out.parent.iterdir()] == [out.name]
    assert bm.SRC.read_bytes() == src


# -- edge_auc -------------------------------------------------------------

def test_edge_from_depth_equals_jax(kitti, tmp_path):
    """The Canny map and the JPEG file's bytes, from a .npy, a uint16 PNG
    and an array, resized or not."""
    gts, _, preds = kitti
    for src in (preds[0], gts[0], np.load(preds[1])):
        for shape in (None, KITTI_GT[::-1]):
            for t in (20, 120, 240):
                a, b = str(tmp_path / 'a.jpeg'), str(tmp_path / 'b.jpeg')
                got = edge_auc.edge_from_depth(src, shape, a, thresh_1=t // 2, thresh_2=t)
                want = jauc.edge_from_depth(src, shape, b, thresh_1=t // 2, thresh_2=t)
                np.testing.assert_array_equal(got, want)
                assert open(a, 'rb').read() == open(b, 'rb').read()


def test_evaluate_boundaries_bin_equals_jax():
    rng = np.random.RandomState(6)
    for thinning in (True, False):
        pred = random_map(rng, 80, 120, 0.2)
        gts = [random_map(rng, 80, 120, 0.05) for _ in range(2)]
        got = edge_auc.evaluate_boundaries_bin(pred, gts, 0.0075, thinning)
        want = jauc.evaluate_boundaries_bin(pred, gts, 0.0075, thinning)
        assert [int(v) for v in got] == [int(v) for v in want]
        assert edge_auc.compute_rec_prec_f1(*map(float, got)) == \
            jauc.compute_rec_prec_f1(*map(float, want))
    for counts in ((0.0, 0.0, 0.0, 0.0), (3.0, 7.0, 0.0, 5.0), (2.0, 9.0, 4.0, 4.0)):
        assert edge_auc.compute_rec_prec_f1(*counts) == jauc.compute_rec_prec_f1(*counts)


@pytest.mark.parametrize('tree,crop,multiscale', [('kitti', KITTI_CROP, False),
                                                  ('kitti', KITTI_CROP, True),
                                                  ('ddad', [], False),
                                                  ('ddad', None, False)])
def test_pr_evaluation_equals_jax(request, tmp_path, tree, crop, multiscale):
    """Precision and recall at every threshold equal as floats; a GT list
    with two entries per frame keeps the first of each pair."""
    _, edges, preds = request.getfixturevalue(tree)
    gt_list = [e for e in edges for _ in range(2)] if multiscale else edges
    thresholds = [20, 100, 240] if multiscale else None
    got = edge_auc.pr_evaluation(gt_list, preds, thresholds, gt_crop=crop,
                                 save_folder=str(tmp_path / 'port'), num_workers=1)
    want = jauc.pr_evaluation(gt_list, preds, thresholds, gt_crop=crop,
                              save_folder=str(tmp_path / 'jax'), num_workers=1)
    assert got == want
    assert len(got[0]) == (3 if multiscale else 12) and 0 < min(got[1]) < max(got[1]) <= 1
    for a in sorted(os.listdir(tmp_path / 'port')):
        assert (tmp_path / 'port' / a).read_bytes() == (tmp_path / 'jax' / a).read_bytes()


@pytest.mark.parametrize('prec_range', [(0.12, 0.65), (0.14, 0.37), (0.29, 0.57), (0.0, 1.0)])
def test_mean_recall_at_precision_range_equals_jax(prec_range):
    rng = np.random.RandomState(7)
    for _ in range(5):
        pr = np.stack([np.sort(rng.rand(12)), np.sort(rng.rand(12))[::-1]], 1)
        assert edge_auc.mean_recall_at_precision_range(pr, *prec_range) == \
            jauc.mean_recall_at_precision_range(pr, *prec_range)


def test_edge_auc_equals_jax(kitti, tmp_path):
    """Full and partial AUC equal as floats, the port's pool (2 spawned
    workers) against the JAX package's serial run."""
    _, edges, preds = kitti
    got = edge_auc.edge_auc(edges, preds, prec_range=(0.14, 0.37), gt_crop=KITTI_CROP,
                            save_folder=str(tmp_path / 'port'), num_workers=2)
    want = jauc.edge_auc(edges, preds, prec_range=(0.14, 0.37), gt_crop=KITTI_CROP,
                         save_folder=str(tmp_path / 'jax'), num_workers=1)
    assert got['matcher'] == 'native'
    for key in ('auc_full', 'auc_partial', 'precision', 'recall'):
        assert got[key] == want[key], key
    assert 0.0 < got['auc_full'] < 1.0 and 0.0 < got['auc_partial'] <= 1.0


# -- d3r ------------------------------------------------------------------

def test_d3r_equals_jax(kitti):
    gts, _, preds = kitti
    rng = np.random.RandomState(8)
    gt = rng.uniform(1, 80, (60, 90))
    gt[rng.rand(60, 90) < 0.5] = 0
    cases = [(gt, gt * 1.01 + rng.randn(60, 90)), (gt, gt), (gt[:2, :2], gt[:2, :2]),
             (np.zeros((5, 5)), np.ones((5, 5)))]
    for g, p in zip(gts, preds):
        d_gt = da.read_png_depth(g)
        cases.append((d_gt, np.load(p)[:KITTI_GT[0], :KITTI_GT[1]]))
    for seed in (0, 3):
        for g, p in cases:
            got = d3r.d3r_metric(g, p, seed=seed)
            assert got == jd3r.d3r_metric(g, p, seed=seed)
            assert isinstance(got, float)
    assert d3r.d3r_metric(gt, gt * 2, num_pairs=100, tol=0.5) == \
        jd3r.d3r_metric(gt, gt * 2, num_pairs=100, tol=0.5)


# -- depth_analyzer -------------------------------------------------------

def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for r, s in zip(got, want):
        assert len(r) == len(s) == len(da.COLUMNS)
        for a, b in zip(r, s):
            assert type(a) is type(b) and (a == b or (np.isnan(a) and np.isnan(b))), (r, s)


@pytest.mark.parametrize('median_scaling,crop,mask', [
    ('none', KITTI_CROP, False), ('median', KITTI_CROP, False),
    ('none', [], False), ('median_of_fractions', [], True)])
def test_analyzer_rows_equal_jax(kitti, tmp_path, median_scaling, crop, mask):
    gts, edges, preds = kitti
    lists = [write_list(tmp_path / f'{n}.txt', x)
             for n, x in (('im', gts), ('gt', gts), ('pred', preds))]
    cfg = {'min_depth': 0.01, 'max_depth': 80.0, 'gt_crop': crop,
           'median_scaling': median_scaling,
           'eval_mask_image_list': write_list(tmp_path / 'mask.txt', edges) if mask else ''}
    sides = []
    for pkg, node in ((da, ConfigNode), (jda, JConfigNode)):
        loader = pkg.DepthEvalLoader(*lists)
        analyzer = pkg.DensePredictionAnalyzer(node(cfg))
        for i in range(len(loader)):
            _, gt, d = loader[i]
            assert gt.shape == KITTI_PRED
            m = None
            if mask:
                import cv2
                m = cv2.resize(cv2.imread(edges[i])[:, :, 0], KITTI_PRED[::-1])
            analyzer.eval_frame(i, gt, d, m)
        sides.append(analyzer.per_frm_res)
    assert_rows_equal(*sides)


def test_analyzer_nan_rows_and_masked_frames():
    """A frame whose every GT pixel is masked out gives NaN rows on both
    sides; a prediction equal to GT gives zero errors."""
    rng = np.random.RandomState(9)
    gt = rng.uniform(1, 60, (30, 40)).astype(np.float32)
    cfg = {'min_depth': 0.01, 'max_depth': 80.0, 'gt_crop': [0, 40, 0, 30],
           'median_scaling': 'median', 'eval_mask_image_list': ''}
    rows = []
    for pkg, node in ((da, ConfigNode), (jda, JConfigNode)):
        analyzer = pkg.DensePredictionAnalyzer(node(cfg))
        analyzer.eval_frame(0, gt, gt)
        analyzer.eval_frame(1, np.full_like(gt, 100.0), gt)
        analyzer.eval_frame(2, gt, gt * 1.3, np.zeros((30, 40), np.uint8))
        rows.append(analyzer.per_frm_res)
    assert_rows_equal(*rows)
    assert rows[0][0][3] == 0.0 and np.isnan(rows[0][1][1]) and np.isnan(rows[0][2][4])


def test_run_analysis_pickle_and_csv_equal_jax(kitti, tmp_path):
    """``run_analysis``: the per-frame rows, the pickle's contents (the two
    packages' ConfigNode classes differ, so not its bytes) and the mean CSV,
    byte-equal to JAX's ``DataFrame.mean().to_csv``."""
    gts, _, preds = kitti
    lists = [write_list(tmp_path / f'{n}.txt', x)
             for n, x in (('im', gts), ('gt', gts), ('pred', preds))]
    an = {'min_depth': 0.01, 'max_depth': 80.0, 'gt_crop': KITTI_CROP, 'median_scaling': 'none',
          'eval_mask_image_list': '', 'start_frm_idx': 1, 'end_frm_idx': -1,
          'out_file_name': ['frames.pkl']}
    out = {}
    for tag, pkg, node in (('port', da, ConfigNode), ('jax', jda, JConfigNode)):
        cfg = node({'analysis': an, 'save': {'folder': str(tmp_path / tag)}})
        analyzer = pkg.DensePredictionAnalyzer(cfg.analysis)
        res = pkg.run_analysis(pkg.DepthEvalLoader(*lists), analyzer, cfg, verbose=False)
        with open(tmp_path / tag / 'sfm_analysis' / 'frames.pkl', 'rb') as f:
            out[tag] = (res, analyzer.per_frm_res, pickle.load(f))
    (rows, _, got), (df, jax_rows, want) = out['port'], out['jax']
    assert_rows_equal(rows, jax_rows)
    assert got['columns'] == want['columns'] == da.COLUMNS
    np.testing.assert_array_equal(got['per_frm_res'], want['per_frm_res'])
    assert got['per_frm_res'].shape == (2, 7)
    assert got['analysis_cfg'] == want['analysis_cfg']
    da.write_mean_csv(rows, tmp_path / 'port.csv')
    df.mean().to_csv(tmp_path / 'jax.csv')
    assert (tmp_path / 'port.csv').read_bytes() == (tmp_path / 'jax.csv').read_bytes()


@pytest.mark.parametrize('n', [1, 3, 9, 115])
def test_mean_csv_bytes_equal_pandas(tmp_path, n):
    """NaN-skipping means in each column's dtype, float32 accuracies and an
    all-NaN column included, byte-equal to pandas for row counts on either
    side of numpy's 8-way summation blocks."""
    import pandas as pd
    rng = np.random.RandomState(n)
    rows = [[i, np.float64(rng.randn()), np.float64(rng.rand()), np.float64(rng.rand() * 0.3),
             np.float32(rng.rand()), np.float32(np.nan), 1.0 + rng.rand()] for i in range(n)]
    rows[0][1] = np.nan
    da.write_mean_csv(rows, tmp_path / 'port.csv')
    pd.DataFrame(rows, columns=da.COLUMNS).mean().to_csv(tmp_path / 'pandas.csv')
    assert (tmp_path / 'port.csv').read_bytes() == (tmp_path / 'pandas.csv').read_bytes()
    analyzer = da.DensePredictionAnalyzer(ConfigNode({}))
    analyzer.per_frm_res = rows
    pd.testing.assert_frame_equal(analyzer.get_frm_metrics_df(),
                                  pd.DataFrame(rows, columns=da.COLUMNS))


def test_error_functions_equal_jax():
    rng = np.random.RandomState(10)
    gt = rng.uniform(1, 50, (20, 30))
    gt[rng.rand(20, 30) < 0.3] = -1
    d = gt * rng.uniform(0.8, 1.2, gt.shape)
    for name in ('rel_err', 'abs_rel_err', 'sq_rel_err'):
        np.testing.assert_array_equal(getattr(da, name)(d, gt), getattr(jda, name)(d, gt))
    for t in (1.1, 1.25):
        np.testing.assert_array_equal(da.accuracy(d, gt, t), jda.accuracy(d, gt, t))


def test_loader_rejects_lists_of_unequal_length(tmp_path):
    a = write_list(tmp_path / 'a.txt', ['x', 'y'])
    b = write_list(tmp_path / 'b.txt', ['x'])
    with pytest.raises(ValueError, match='listed'):
        da.DepthEvalLoader(a, a, b)


# -- the Spectral colour map ----------------------------------------------

def spectral_by_matplotlib(x):
    """The JAX CLI's expression (``mindtheedge_tpu/cli/infer_edges.py:136-140``)."""
    import matplotlib as mpl
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt
    mapper = cm.ScalarMappable(norm=mpl.colors.Normalize(0.0, 1.0),
                               cmap=plt.get_cmap('Spectral'))
    return (mapper.to_rgba(x)[:, :, :3] * 255).astype(np.uint8)


def test_colour_png_byte_equal_matplotlib(tmp_path):
    """``save_depth_outputs``'s colour PNG against the matplotlib expression
    on seeded depth maps: smooth, noisy, constant, with zeros, all zeros;
    and the table's every bin, ends and NaN."""
    import cv2
    from mindtheedge_tpu_torch.cli.infer_edges import save_depth_outputs
    from mindtheedge_tpu_torch.utils.colormap import spectral_u8
    rng = np.random.RandomState(11)
    smooth = blocky_depth(rng, 48, 64).astype(np.float32)
    zeros = smooth.copy()
    zeros[rng.rand(48, 64) < 0.2] = 0.0
    maps = [smooth, rng.uniform(0.5, 80, (48, 64)).astype(np.float32),
            np.full((48, 64), 7.5, np.float32), zeros, np.zeros((48, 64), np.float32),
            rng.uniform(1, 2, (375, 1242)).astype(np.float32)]
    for i, depth in enumerate(maps):
        base = str(tmp_path / f'{i}')
        save_depth_outputs(depth, base)
        depth_log = np.log(np.clip(depth, 1e-12, None))
        depth_log = depth_log - depth_log.min()
        depth_log = depth_log / max(depth_log.max(), 1e-12)
        want = spectral_by_matplotlib(depth_log)
        got = cv2.imread(base + '_regular_color.png', cv2.IMREAD_UNCHANGED)[:, :, ::-1]
        np.testing.assert_array_equal(got, want)
    for dtype in (np.float32, np.float64):
        x = np.concatenate([np.arange(257) / 256, np.linspace(0, 1, 1001), rng.rand(3000),
                            [-0.5, 1.5, np.nan, 1.0 - 1e-9, 1e-9, np.inf]]).astype(dtype)[None]
        np.testing.assert_array_equal(spectral_u8(x), spectral_by_matplotlib(x))


# -- utils: save, reduce, misc, logging (item 18) -------------------------

def test_save_helpers_equal_jax(tmp_path):
    from mindtheedge_tpu.utils import save as jsave
    from mindtheedge_tpu_torch.utils import save
    paths = ['a/b.npy', 'c.npy']
    for pkg, tag in ((save, 'port'), (jsave, 'jax')):
        assert pkg.save_paths_list(paths, str(tmp_path / tag)) == str(tmp_path / tag / 'pred_list.txt')
    assert (tmp_path / 'port' / 'pred_list.txt').read_bytes() == \
        (tmp_path / 'jax' / 'pred_list.txt').read_bytes()
    rng = np.random.RandomState(12)
    inv = rng.rand(24, 32)
    inv[:4] = 0
    for kwargs in ({}, {'filter_zeros': True}, {'normalizer': 0.5, 'colormap': 'viridis'}):
        np.testing.assert_array_equal(save.viz_inv_depth(inv, **kwargs),
                                      jsave.viz_inv_depth(inv, **kwargs))
    depth = rng.uniform(0, 80, (24, 32)).astype(np.float32)
    rgb = rng.rand(24, 32, 3)
    for pkg, tag in ((save, 'port'), (jsave, 'jax')):
        pkg.save_depth(str(tmp_path / tag / 'd' / 'x.png'), depth, rgb=rgb)
    for name in ('x.png', 'x_viz.png', 'x_rgb.png'):
        assert (tmp_path / 'port' / 'd' / name).read_bytes() == \
            (tmp_path / 'jax' / 'd' / name).read_bytes(), name
    for tag in ('port', 'jax'):
        np.testing.assert_array_equal(np.load(tmp_path / tag / 'd' / 'x.npz')['depth'], depth)


def test_reduce_helpers_equal_jax():
    from mindtheedge_tpu.utils import reduce as jreduce
    from mindtheedge_tpu_torch.utils import reduce
    rng = np.random.RandomState(13)
    metrics = [[{'idx': np.array([0, 1]), 'depth': rng.rand(2, 7), 'depth_gt': rng.rand(2, 7)},
                {'idx': np.array([1, 3]), 'depth': rng.rand(2, 7), 'depth_gt': rng.rand(2, 7)}],
               [{'idx': np.array([2]), 'depth': rng.rand(1, 7)}]]
    got = reduce.all_reduce_metrics(metrics, [5, 4])
    want = jreduce.all_reduce_metrics(metrics, [5, 4])
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert reduce.create_dict(got[0]) == jreduce.create_dict(want[0])
    assert len(reduce.create_dict(got[0])) == 14
    outs = [{'loss': 1.5, 'metrics': {'a': 1.0, 'b': 2.0}}, {'loss': torch.tensor(0.5),
            'metrics': {'a': 3.0}}, {'metrics': {'b': np.float32(4.0)}}]
    assert reduce.average_loss_and_metrics(outs) == jreduce.average_loss_and_metrics(outs)
    assert reduce.average_loss_and_metrics(outs, 'val') == {'val-loss': 1.0, 'val-a': 2.0,
                                                            'val-b': 3.0}


def test_misc_and_logging_equal_jax(capsys):
    from mindtheedge_tpu.utils import logging as jlogging, misc as jmisc
    from mindtheedge_tpu_torch.utils import logging, misc
    assert misc.filter_dict({'a': 1, 'c': 2}, ['a', 'b', 'c']) == \
        jmisc.filter_dict({'a': 1, 'c': 2}, ['a', 'b', 'c']) == ['a', 'c']
    for args in ((3,), ([1, 2],), (5, 3), ([5], 2), ([1, 2], 2)):
        assert misc.make_list(*args) == jmisc.make_list(*args)
    with pytest.raises(ValueError):
        misc.make_list([1, 2], 3)
    assert misc.same_shape((2, 3), [2, 3]) and not misc.same_shape((2, 3), (3, 2))
    assert misc.parse_crop_borders((1, 2, 3, 4), (10, 20)) == \
        jmisc.parse_crop_borders((1, 2, 3, 4), (10, 20))
    for args in (('x', 'red'), ('y', 'cyan', None, ['bold']), ('z', 'nope')):
        assert logging.pcolor(*args) == jlogging.pcolor(*args)
    meters = (logging.AvgMeter(3), jlogging.AvgMeter(3))
    for v in (1.0, 2.0, 4.0, 8.0):
        assert meters[0](v) == meters[1](v)
    assert meters[0].get_and_reset() == meters[1].get_and_reset() == 14 / 3
    assert meters[0].get() == 0.0
    metrics = {'loss': 0.25, 'depth/abs_rel': np.float32(0.125), 'vec': [1, 2.5]}
    printed = []
    for pkg in (logging, jlogging):
        pkg.print_metrics_table('Validation', metrics)
        pkg.print_metrics_table('empty', {})
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and 'depth/abs_rel  0.1250' in printed[0]

