"""Supervised depth losses (sparse-l1 / mse / berhu / silog / abs_rel):
counterpart of ``mindtheedge_tpu/losses/supervised.py:14-92`` (reference
``losses/supervised_loss.py``).

Sparse masking follows the reference: select the elements with ``gt > 0``
and reduce over those only (``supervised_loss.py:172-180``), here as
where + sum / count, with ``count = max(n, 1)``.
"""

import torch

from mindtheedge_tpu_torch.utils.image import match_scales


def _masked_mean(value, mask):
    count = torch.clamp(mask.sum().to(value.dtype), min=1.0)
    return torch.where(mask, value, 0.0).sum() / count


def l1_loss(pred, gt, mask):
    return _masked_mean(torch.abs(pred - gt), mask)


def mse_loss(pred, gt, mask):
    return _masked_mean((pred - gt) ** 2, mask)


def abs_rel_loss(pred, gt, mask):
    # reference: mean(|x - y| / x) with x = pred (supervised_loss.py:84)
    return _masked_mean(torch.abs(pred - gt) / torch.where(mask, pred, 1.0), mask)


def berhu_loss(pred, gt, mask, threshold=0.2):
    """BerHu (``supervised_loss.py:13-55``): L1 below c, squared above, with
    ``c = threshold * max(pred - gt)`` over valid elements.  The reference
    concatenates diff with the above-c diff^2 before the mean:
    (sum(diff) + sum(diff2[above])) / (n + n_above)."""
    diff = torch.abs(pred - gt)
    c = threshold * torch.where(mask, pred - gt, -3.4e38).max()
    above = (diff > c) & mask
    total = torch.where(mask, diff, 0.0).sum() + torch.where(above, diff ** 2, 0.0).sum()
    return total / torch.clamp((mask.sum() + above.sum()).to(pred.dtype), min=1.0)


def silog_loss(pred, gt, mask, ratio=10.0, ratio2=0.85):
    """Scale-invariant log loss (``supervised_loss.py:57-69``):
    ``sqrt(max(silog1 - silog2, 0)) * ratio``.  ``torch.maximum`` splits the
    gradient at a tie as JAX's ``maximum`` does; the difference is 0 only
    when no element is valid, and then every gradient is masked to 0."""
    log_diff = torch.log(torch.where(mask, pred, 1.0) * ratio) - \
        torch.log(torch.where(mask, gt, 1.0) * ratio)
    silog1 = _masked_mean(log_diff ** 2, mask)
    silog2 = ratio2 * _masked_mean(log_diff, mask) ** 2
    return torch.sqrt(torch.maximum(silog1 - silog2, silog1.new_zeros(()))) * ratio


_LOSS_FNS = {
    'l1': l1_loss,
    'mse': mse_loss,
    'berhu': berhu_loss,
    'silog': silog_loss,
    'abs_rel': abs_rel_loss,
}


def get_loss_fn(supervised_method):
    """Name dispatch by suffix (``supervised_loss.py:73-86``)."""
    for name, fn in _LOSS_FNS.items():
        if supervised_method.endswith(name):
            return fn
    raise ValueError(f'Unknown supervised loss {supervised_method}')


def supervised_loss(inv_depths, gt_inv_depth, supervised_method='sparse-l1',
                    num_scales=4):
    """Per-scale mean of the supervised loss on inverse depth.

    ``inv_depths``: list of [B,h,w,1] predictions (full resolution first);
    ``gt_inv_depth``: [B,H,W,1], matched to each scale by nearest resize
    (``supervised_loss.py:207-208``).  Sparse methods mask by gt > 0;
    predictions get +1e-5 (``:179``).
    """
    loss_fn = get_loss_fn(supervised_method)
    sparse = supervised_method.startswith('sparse')
    gts = match_scales(gt_inv_depth, inv_depths, num_scales, mode='nearest')
    total = 0.0
    for i in range(num_scales):
        mask = gts[i] > 0.0 if sparse else torch.ones_like(gts[i], dtype=torch.bool)
        total = total + loss_fn(inv_depths[i] + 1e-5, gts[i], mask)
    return total / num_scales
