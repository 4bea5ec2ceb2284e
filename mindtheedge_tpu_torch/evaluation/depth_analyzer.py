"""Dense depth metrics per frame: counterpart of
``mindtheedge_tpu/evaluation/depth_analyzer.py:1-164`` (reference root
``eval_depth.py``).

Per frame: mean and std of the relative error, abs_rel, accuracy at 1.1 and
1.25 and the median scale factor, over GT inside (min_depth, max_depth)
and the crop or mask; the rows go to a pickle, and their NaN-skipping
column means to ``mean_frames_depth_metrics.csv``.  The CSV is written with
numpy, byte-equal to the JAX package's ``DataFrame.mean().to_csv``, so the
evaluation runs where pandas is absent; ``get_frm_metrics_df`` still
returns a DataFrame to callers that have pandas.
"""

import os
import pickle

import numpy as np

from mindtheedge_tpu_torch.data.augmentations import resize_depth_preserve
from mindtheedge_tpu_torch.data.readers import depth_read_bin, read_png_depth

EPS = np.finfo(float).eps

COLUMNS = ['frm_idx', 'mean_rel_err', 'std_rel_err', 'abs_rel_err',
           'accuracy_1p1', 'accuracy_1p25', 'median_scale_factor']


def rel_err(d, d_gt):
    m = (d - d_gt) / (d_gt + EPS)
    m[d_gt == -1] = np.nan
    return m


def abs_rel_err(d, d_gt):
    m = np.abs((d - d_gt) / (d_gt + EPS))
    m[d_gt == -1] = np.nan
    return m


def sq_rel_err(d, d_gt):
    m = ((d - d_gt) ** 2) / (d_gt + EPS)
    m[d_gt == -1] = np.nan
    return m


def accuracy(d, d_gt, thresh):
    dev_max = np.maximum(np.abs(d / (d_gt + EPS)), np.abs(d_gt / (d + EPS)))
    out = (dev_max < thresh).astype('float32')
    out[d_gt == -1] = np.nan
    return out


def column_means(rows):
    """[(column, mean)] of per-frame ``rows``, as pandas' ``DataFrame.mean``
    computes them: each column in the dtype numpy infers for it (float32
    where the values are, as the accuracies), NaN skipped, the sum in that
    dtype by numpy's contiguous sum, divided by the count; an integer
    column in float64; NaN where a column has no value."""
    means = []
    for j, name in enumerate(COLUMNS):
        col = np.array([r[j] for r in rows])
        if col.dtype.kind != 'f':
            means.append((name, float(col.sum(dtype=np.float64) / np.float64(len(col)))))
            continue
        valid = ~np.isnan(col)
        count = col.dtype.type(valid.sum())
        total = np.where(valid, col, 0).astype(col.dtype).sum(dtype=col.dtype)
        means.append((name, float(total / count) if count > 0 else float('nan')))
    return means


def write_mean_csv(rows, path):
    """``mean_frames_depth_metrics.csv`` of per-frame ``rows``, byte-equal to
    ``DataFrame(rows, columns=COLUMNS).mean().to_csv(path)``: a ``,0``
    header, one ``name,value`` line per column, ``repr`` floats, NaN empty."""
    with open(path, 'w') as f:
        f.write(',0\n')
        for name, value in column_means(rows):
            f.write(f'{name},{"" if np.isnan(value) else repr(value)}\n')


class DepthEvalLoader:
    """Lists of (image, GT, prediction) paths (``depth_analyzer.py:48-82``)."""

    def __init__(self, image_list_path, gt_list_path, depth_pred_list_path):
        def read(path):
            with open(path) as f:
                return f.read().splitlines()
        self.images = read(image_list_path)
        self.gts = read(gt_list_path)
        self.preds = read(depth_pred_list_path)
        if not len(self.images) == len(self.gts) == len(self.preds):
            raise ValueError(f'{len(self.images)} images, {len(self.gts)} GT '
                             f'maps and {len(self.preds)} predictions listed')

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        """-> (image, GT resized to the prediction's shape, prediction)."""
        import cv2
        im = cv2.imread(self.images[i])
        gt_path, pred_path = self.gts[i], self.preds[i]
        if gt_path.endswith('.npy'):
            gt = np.load(gt_path)
        elif gt_path.endswith('.png'):
            gt = read_png_depth(gt_path)
        elif gt_path.endswith('.bin'):
            gt = depth_read_bin(gt_path)
        else:
            raise ValueError('Depth GT must be .png/.npy/.bin')
        if pred_path.endswith('.npy'):
            d = np.load(pred_path)
        elif pred_path.endswith('.txt'):
            d = np.genfromtxt(pred_path, delimiter=',')
        else:
            raise ValueError('Prediction must be .npy or .txt')
        if d.shape != gt.shape:
            gt = resize_depth_preserve(gt, d.shape[:2])[:, :, 0]
        return im, gt, d


class DensePredictionAnalyzer:
    """Per-frame dense depth analyzer (``depth_analyzer.py:85-144``)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.per_frm_res = []
        self.eval_mask_list = None
        if getattr(cfg, 'eval_mask_image_list', ''):
            with open(cfg.eval_mask_image_list) as f:
                self.eval_mask_list = f.read().splitlines()

    def _mask_gt(self, gt, gt_crop_im=None):
        mask = (gt > self.cfg.min_depth) & (gt < self.cfg.max_depth)
        gt_crop = self.cfg.gt_crop
        if gt_crop_im is None:
            if gt_crop and len(gt_crop) == 4:
                crop_mask = np.zeros(mask.shape)
                crop_mask[int(gt_crop[2]):int(gt_crop[3]),
                          int(gt_crop[0]):int(gt_crop[1])] = 1
            else:
                crop_mask = np.ones(mask.shape)
        else:
            crop_mask = gt_crop_im > 0
        mask = mask & (crop_mask > 0)
        out = gt.copy()
        out[~mask] = -1
        return out

    def eval_frame(self, frm_idx, gt, d, gt_crop_im=None):
        gt = self._mask_gt(gt, gt_crop_im)
        scale_factor = 1.0
        if getattr(self.cfg, 'median_scaling', 'none') not in ('none', '', None):
            valid = gt != -1
            if valid.any():
                scale_factor = float(np.median(gt[valid]) /
                                     max(np.median(d[valid]), EPS))
                d = d * scale_factor
        vals = {
            'abs_rel_err': np.nanmean(abs_rel_err(d, gt)),
            'accuracy_1p1': np.nanmean(accuracy(d, gt, 1.1)),
            'accuracy_1p25': np.nanmean(accuracy(d, gt, 1.25)),
            'median_scale_factor': scale_factor,
            'mean_rel_err': np.nanmean(rel_err(d, gt)),
            'std_rel_err': np.nanstd(rel_err(d, gt)),
        }
        self.per_frm_res.append([frm_idx] + [vals[c] for c in COLUMNS[1:]])
        return {'vals': vals}

    def get_frm_metrics_df(self):
        """The per-frame rows as a pandas DataFrame (pandas imported here)."""
        import pandas as pd
        return pd.DataFrame(self.per_frm_res, columns=COLUMNS)

    def save_results(self, output_dir, out_file_name, verbose=True):
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, out_file_name)
        with open(path, 'wb') as f:
            pickle.dump({'columns': COLUMNS,
                         'per_frm_res': np.array(self.per_frm_res),
                         'analysis_cfg': dict(self.cfg)}, f)
        if verbose:
            print(f'Saved analyzer data to {path}')


def run_analysis(data_loader, analyzer, cfg, verbose=True):
    """Analyze frames and write the pickle (``depth_analyzer.py:147-164``)
    -> the per-frame rows (the JAX function returns them as a DataFrame)."""
    import cv2
    start = cfg.analysis.start_frm_idx
    end = cfg.analysis.end_frm_idx
    if end == -1:
        end = len(data_loader)
    for i in range(start, end):
        if verbose:
            print('Processing frame:', i)
        _, d_gt, d = data_loader[i]
        mask = None
        if analyzer.eval_mask_list is not None:
            mask = cv2.imread(analyzer.eval_mask_list[i])[:, :, 0]
        analyzer.eval_frame(i, d_gt, d, mask)
    out_name = cfg.analysis.out_file_name
    if isinstance(out_name, (list, tuple)):
        out_name = out_name[0]
    analyzer.save_results(os.path.join(cfg.save.folder, 'sfm_analysis'), out_name)
    return analyzer.per_frm_res
