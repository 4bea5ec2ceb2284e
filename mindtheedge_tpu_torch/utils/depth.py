"""Depth utilities on NHWC tensors: counterpart of
``mindtheedge_tpu/utils/depth.py`` (reference ``utils/depth.py``):
inverse depth <-> depth, flip-fusion post-processing and the 7-metric depth
evaluation (abs_rel, sq_rel, rmse, rmse_log, a1/a2/a3 with the garg crop
and median scaling).
"""

import numpy as np
import torch

from mindtheedge_tpu_torch.utils.image import flip_lr, resize_bilinear

DEPTH_METRIC_NAMES = ('abs_rel', 'sqr_rel', 'rmse', 'rmse_log', 'a1', 'a2', 'a3')


def inv2depth(inv_depth):
    """1 / clamp(inv, min=1e-6) (reference ``utils/depth.py:104-121``)."""
    if isinstance(inv_depth, (list, tuple)):
        return [inv2depth(d) for d in inv_depth]
    return 1.0 / torch.clamp(inv_depth, min=1e-6)


def depth2inv(depth):
    """1/depth with invalid (<= 0) pixels set to 0 (``utils/depth.py:124-144``)."""
    if isinstance(depth, (list, tuple)):
        return [depth2inv(d) for d in depth]
    inv = 1.0 / torch.clamp(depth, min=1e-6)
    return torch.where(depth <= 0.0, 0.0, inv)


def fuse_inv_depth(inv_depth, inv_depth_hat, method='mean'):
    if method == 'mean':
        return 0.5 * (inv_depth + inv_depth_hat)
    if method == 'max':
        return torch.maximum(inv_depth, inv_depth_hat)
    if method == 'min':
        return torch.minimum(inv_depth, inv_depth_hat)
    raise ValueError(f'Unknown post-process method {method}')


def post_process_inv_depth(inv_depth, inv_depth_flipped, method='mean'):
    """Flip-fusion with the 5 %-border ramp mask (``utils/depth.py:230-256``):
    ``inv_depth_flipped`` is the network's output on the flipped input."""
    w = inv_depth.shape[2]
    inv_depth_hat = flip_lr(inv_depth_flipped)
    fused = fuse_inv_depth(inv_depth, inv_depth_hat, method=method)
    xs = torch.linspace(0.0, 1.0, w, dtype=inv_depth.dtype,
                        device=inv_depth.device)[None, None, :, None]
    mask = (1.0 - torch.clamp(20.0 * (xs - 0.05), 0.0, 1.0)).expand(inv_depth.shape)
    mask_hat = flip_lr(mask)
    return mask_hat * inv_depth + mask * inv_depth_hat + \
        (1.0 - mask - mask_hat) * fused


def scale_depth(pred, gt_shape, scale_fn='resize'):
    """Match a [B,h,w,C] prediction to the GT resolution
    (``utils/depth.py:328-361``): 'resize' = bilinear with align_corners;
    'top-center' = zero-pad the top and centre horizontally."""
    gh, gw = gt_shape
    if pred.shape[1] == gh and pred.shape[2] == gw:
        return pred
    if scale_fn == 'resize':
        return resize_bilinear(pred, (gh, gw), align_corners=True)
    if scale_fn == 'top-center':
        top = gh - pred.shape[1]
        left = (gw - pred.shape[2]) // 2
        out = pred.new_zeros((pred.shape[0], gh, gw, pred.shape[3]))
        out[:, top:top + pred.shape[1], left:left + pred.shape[2]] = pred
        return out
    raise NotImplementedError(f'Depth scale function {scale_fn} not implemented.')


def _masked_median(x, mask):
    """Median of ``x`` over ``mask`` (mean of the two middle values), by a
    sort in which masked-out entries sort last; no host sync."""
    big = torch.finfo(x.dtype).max
    n = mask.sum()
    xs = torch.sort(torch.where(mask, x, big).reshape(-1)).values
    idx = torch.stack([torch.clamp((n - 1) // 2, min=0), n // 2])
    return 0.5 * torch.take(xs, idx).sum()


def compute_depth_metrics(gt, pred, min_depth=0.0, max_depth=80.0,
                          crop='garg', scale_output='resize',
                          use_gt_scale=True):
    """7-metric depth evaluation (``utils/depth.py:259-325``).

    gt, pred: [B,H,W,1].  Returns a [7] tensor, abs_rel, sq_rel, rmse,
    rmse_log, a1, a2, a3, averaged over the batch; a sample without valid
    pixels counts as zeros, like the reference's ``continue``.
    """
    b, gh, gw, _ = gt.shape
    pred = scale_depth(pred, (gh, gw), scale_output)
    valid = (gt > min_depth) & (gt < max_depth)
    if crop == 'garg':
        y1, y2 = int(0.40810811 * gh), int(0.99189189 * gh)
        x1, x2 = int(0.03594771 * gw), int(0.96405229 * gw)
        cm = np.zeros((gh, gw), dtype=bool)
        cm[y1:y2, x1:x2] = True
        valid = valid & torch.from_numpy(cm).to(gt.device)[None, :, :, None]

    total = torch.zeros(7, dtype=torch.float32, device=gt.device)
    for gt_i, pred_i, m in zip(gt[..., 0], pred[..., 0], valid[..., 0]):
        n = m.sum()
        count = torch.clamp(n, min=1)
        if use_gt_scale:
            med_gt = _masked_median(gt_i, m)
            med_pred = _masked_median(pred_i, m)
            pred_i = pred_i * med_gt / torch.clamp(med_pred, min=1e-12)
        pred_i = torch.clamp(pred_i, min_depth, max_depth)
        safe_gt = torch.where(m, gt_i, 1.0)
        safe_pred = torch.where(m, pred_i, 1.0)

        def mean(v):
            return torch.where(m, v, 0.0).sum() / count

        thresh = torch.maximum(safe_gt / safe_pred, safe_pred / safe_gt)
        diff = safe_gt - safe_pred
        metrics = torch.stack([
            mean(torch.abs(diff) / safe_gt),
            mean(diff ** 2 / safe_gt),
            torch.sqrt(mean(diff ** 2)),
            torch.sqrt(mean((torch.log(safe_gt) - torch.log(safe_pred)) ** 2)),
            mean((thresh < 1.25).float()),
            mean((thresh < 1.25 ** 2).float()),
            mean((thresh < 1.25 ** 3).float())])
        total = total + torch.where(n > 0, metrics, 0.0)
    return total / b
