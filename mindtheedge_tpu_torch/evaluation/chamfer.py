"""Chamfer edge distance by a Euclidean distance transform: counterpart of
``mindtheedge_tpu/evaluation/chamfer.py`` (reference ``utils/edge.py:20-62``).
Host-side numpy and scipy, imported inside the function."""

import numpy as np


def chamfer_distance(im_pred, im_gt, mask=None, edge_to_edge_thresh=5):
    """Returns (c_dist, percentage, cond_map): the mean distance of the
    predicted edge pixels to the nearest GT edge pixel, the share of them
    within ``edge_to_edge_thresh`` px, and the per-pixel map.

    im_pred / im_gt: edge maps in [0, 255] (binarised at 0.5 after /255).
    """
    from scipy import ndimage

    im_gt_norm = np.where(im_gt / 255.0 > 0.5, 1.0, 0.0)
    im_pred_norm = np.where(im_pred / 255.0 > 0.5, 1.0, 0.0)
    if mask is not None:
        im_gt_norm = im_gt_norm * mask
        im_pred_norm = im_pred_norm * mask

    gt_dist = ndimage.distance_transform_edt(1 - im_gt_norm.astype('uint8'))
    pred_sum = im_pred_norm.sum()
    c_dist = (gt_dist * im_pred_norm).sum() / max(pred_sum, 1e-12)

    gt_flat = gt_dist.flatten()
    pred_flat = im_pred_norm.flatten()
    on = np.where(pred_flat >= 0.5)[0]
    within = gt_flat[on] < edge_to_edge_thresh
    percentage = within.sum() / max(pred_sum, 1e-12)

    cond = gt_flat.copy()
    cond[on] = within
    cond[pred_flat < 0.5] = -1
    return c_dist, percentage, cond.reshape(gt_dist.shape)
