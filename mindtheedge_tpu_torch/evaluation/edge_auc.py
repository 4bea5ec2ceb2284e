"""KITTI-DE / DDAD-DE edge AUC (the BSDS-style PR protocol): counterpart of
``mindtheedge_tpu/evaluation/edge_auc.py:1-181``.

    depth .npy -> resize to the GT's shape (cv2 INTER_LINEAR) -> clip
    [min, max] -> x255/max uint8 -> cv2.Canny(t/2, t) for t in 20..240 step
    20 -> JPEG file -> re-read, > 0.5 -> crop -> maximum-cardinality pixel
    match (max_dist 0.002) -> a PR point per threshold -> mean recall over
    a precision range.

Host code, equal to the JAX package's: the same cv2 calls in the same
order, the JPEG round trip of every Canny map included (compression can
flip isolated pixels, and the reference matches the re-read file), and the
same float expressions.  Frames are matched in a pool of ``num_workers``
processes, started with ``spawn`` (the caller may hold the card and
threads) after the matcher library is built.
"""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from mindtheedge_tpu_torch.evaluation import bsds_matcher
from mindtheedge_tpu_torch.evaluation.bsds_matcher import binary_thin, correspond_pixels


def edge_from_depth(depth_path, new_shape, out_path=None, min_depth=0.0,
                    max_depth=80.0, thresh_1=20, thresh_2=40,
                    write_edge=True):
    """Canny edges of a depth map (``edge_auc.py:30-55``); ``new_shape`` is
    (W, H), cv2's order, or None; a path to ``.npy`` metric depth or to a
    uint16 PNG, or an array."""
    import cv2
    if isinstance(depth_path, str):
        if depth_path.endswith('.npy'):
            depth = np.load(depth_path)
        else:
            from mindtheedge_tpu_torch.data.readers import load_image
            d = np.array(load_image(depth_path), dtype=int).astype(np.float64)
            d[d == 0] = -1.0
            depth = d
    else:
        depth = np.asarray(depth_path, dtype=np.float64)
    if new_shape is not None:
        depth = cv2.resize(depth, new_shape, interpolation=cv2.INTER_LINEAR)
    depth = np.clip(depth, min_depth, max_depth)
    depth_vis = (depth * (255.0 / max_depth)).astype(np.uint8)
    edge_im = cv2.Canny(depth_vis, thresh_1, thresh_2)
    if write_edge and out_path is not None:
        cv2.imwrite(out_path, edge_im)
    return edge_im


def evaluate_boundaries_bin(pred_bin, gt_boundaries, max_dist=0.0075,
                            apply_thinning=True):
    """(recall hits, GT pixels, precision hits, predicted pixels) of one
    binary prediction against a list of GT maps (``edge_auc.py:58-74``)."""
    pred_bin = np.asarray(pred_bin) != 0
    if apply_thinning:
        pred_bin = binary_thin(pred_bin)
    acc_prec = np.zeros(pred_bin.shape, dtype=bool)
    sum_r = count_r = 0
    for gt in gt_boundaries:
        match1, match2, _, _ = correspond_pixels(pred_bin, gt, max_dist=max_dist)
        acc_prec |= match1 > 0
        sum_r += gt.sum()
        count_r += (match2 > 0).sum()
    return count_r, sum_r, acc_prec.sum(), pred_bin.sum()


def compute_rec_prec_f1(count_r, sum_r, count_p, sum_p):
    rec = count_r / (sum_r + (sum_r == 0))
    prec = count_p / (sum_p + (sum_p == 0))
    f1 = 2.0 * prec * rec / (prec + rec + ((prec + rec) == 0))
    return rec, prec, f1


def _pred_eval(pred_path, gt_path, crop):
    """One frame's counts (``edge_auc.py:84-97``): both maps re-read with
    cv2 and binarised at 0.5, cropped, matched at max_dist 0.002 without
    thinning."""
    import cv2
    pred = cv2.imread(pred_path)[:, :, 0] / 255.0
    pred = np.where(pred > 0.5, 1.0, 0.0)
    gt = cv2.imread(gt_path)[:, :, 0] / 255.0
    gt = np.where(gt > 0.5, 1.0, 0.0)
    if crop is not None and len(crop) > 0:
        pred = pred[crop[2]:crop[3], crop[0]:crop[1]]
        gt = gt[crop[2]:crop[3], crop[0]:crop[1]]
    return evaluate_boundaries_bin(pred, [gt], max_dist=0.002, apply_thinning=False)


def _pred_eval_star(args):
    return _pred_eval(*args)


def pr_evaluation(edge_gt_list, depth_pred_list, edge_thresh_range=None,
                  gt_crop=(44, 1197, 153, 371), min_depth=0.0, max_depth=80.0,
                  save_folder='temp_output', num_workers=4):
    """PR curve over Canny thresholds (``edge_auc.py:100-158``):
    ``edge_gt_list`` GT edge image paths, ``depth_pred_list`` predicted
    depth ``.npy`` paths -> (precision_vec, recall_vec)."""
    import cv2
    os.makedirs(save_folder, exist_ok=True)
    if edge_thresh_range is None:
        edge_thresh_range = list(range(20, 241, 20))

    # a multiscale GT list keeps the first entry of each group (ref :257-260)
    if len(edge_gt_list) > len(depth_pred_list):
        ratio = int(len(edge_gt_list) / len(depth_pred_list))
        edge_gt_list = edge_gt_list[0:len(edge_gt_list):ratio]

    gt_shapes = []
    for gt_path in edge_gt_list:
        gt_im = cv2.imread(gt_path)[:, :, 0]
        gt_shapes.append((gt_im.shape[1], gt_im.shape[0]))

    precision_vec, recall_vec = [], []
    num_workers = max(1, min(num_workers, os.cpu_count() or 1))
    pool = None
    if num_workers > 1:
        bsds_matcher.backend()      # build the library once, before the workers
        pool = ProcessPoolExecutor(max_workers=num_workers,
                                   mp_context=multiprocessing.get_context('spawn'))
    try:
        for thresh in edge_thresh_range:
            pred_paths = []
            for i, depth_path in enumerate(depth_pred_list):
                out_path = os.path.join(save_folder, '{:010d}_pred_canny_edge.jpeg'.format(i))
                edge_from_depth(depth_path, gt_shapes[i], out_path,
                                min_depth=min_depth, max_depth=max_depth,
                                thresh_1=int(thresh / 2), thresh_2=int(thresh))
                pred_paths.append(out_path)

            crop = list(gt_crop) if gt_crop is not None else None
            args = list(zip(pred_paths, edge_gt_list, [crop] * len(pred_paths)))
            if pool is not None:
                results = list(pool.map(_pred_eval_star, args))
            else:
                results = [_pred_eval(*a) for a in args]

            count_r = sum(r[0] for r in results)
            sum_r = sum(r[1] for r in results)
            count_p = sum(r[2] for r in results)
            sum_p = sum(r[3] for r in results)
            rec, prec, _ = compute_rec_prec_f1(
                float(count_r), float(sum_r), float(count_p), float(sum_p))
            precision_vec.append(prec)
            recall_vec.append(rec)
    finally:
        if pool is not None:
            pool.shutdown()
    return precision_vec, recall_vec


def mean_recall_at_precision_range(prec_recall, small_lim=0.0, large_lim=1.0):
    """AUC: the mean recall interpolated over a precision range
    (``edge_auc.py:165-172``); ``int(lim * 100)`` as there, so 0.29 -> 28."""
    arr = np.asarray(prec_recall)
    interp_x = np.array(range(int(small_lim * 100), int(large_lim * 100))) / 100
    interp_y = np.interp(interp_x, arr[:, 0], arr[:, 1])
    interp_y = np.clip(interp_y, 0.0, 1.0)
    return float(np.mean(interp_y))


def edge_auc(edge_gt_list, depth_pred_list, prec_range=(0.12, 0.65),
             save_folder='temp_output', num_workers=4, **kwargs):
    """Full and partial-range AUC in one call (``edge_auc.py:175-181``), and
    which matcher served it (``bsds_matcher.backend``)."""
    prec, rec = pr_evaluation(edge_gt_list, depth_pred_list,
                              save_folder=save_folder,
                              num_workers=num_workers, **kwargs)
    pr = np.vstack((prec, rec)).T
    full = mean_recall_at_precision_range(pr)
    partial = mean_recall_at_precision_range(pr, *prec_range)
    return {'auc_full': full, 'auc_partial': partial,
            'precision': prec, 'recall': rec, 'matcher': bsds_matcher.backend()}
