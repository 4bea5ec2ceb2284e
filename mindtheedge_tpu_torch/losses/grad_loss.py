"""Edge-aware gradient loss, the paper's contribution, in its plain form:
counterpart of ``mindtheedge_tpu/losses/grad_loss.py:100-252`` (reference
``losses/grad_loss.py``, ``losses/attention_loss.py``).

* ``grad_layer``: fixed 3x3 Sobel kernels, zero-padded (v/h and the two
  diagonals); without normals the gradient magnitude
  ``sqrt(x_v^2 + x_h^2 + 1e-6)``, with normals the derivative along the
  normal's bucket (half-open ``[lo, hi)`` at +-pi/8 steps).
* ``class_balanced_bce``: per-sample class-balanced weighted BCE.
* ``attention_loss2``, ``dice_loss``: the other loss types.
* ``grad_loss``: resize the prediction to the GT size, Sobel magnitude,
  ``sigmoid(mag - thresh)``, loss.

The JAX package's W-phase-packed form of the Sobel bank
(``_sobel_bank_packed``) fills the TPU's 128-lane MXU and computes the same
values; it is not ported.  Here the kernels of one call run as one
zero-padded conv with one output channel per kernel.
"""

import functools
import math

import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops.edge_ops import SOBEL3_H, SOBEL3_LR, SOBEL3_RL, SOBEL3_V
from mindtheedge_tpu_torch.utils.image import box_filter_15, resize_bilinear, rgb_to_gray


@functools.lru_cache(maxsize=16)
def _bank_weight(kernels, dtype, device):
    """[n,1,3,3] conv weight of the kernels, made once per device: a copy
    from the host to the card waits for the card."""
    return torch.tensor(kernels, dtype=dtype, device=device)[:, None]


def _sobel3_bank(x, kernels):
    """Zero-padded 3x3 correlations of [B,H,W,1] with each kernel -> list of
    [B,H,W,1] (torch ``F.conv2d``, ``grad_loss.py:26-28``)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), _bank_weight(kernels, x.dtype, x.device),
                 padding=1)
    return [y[:, i:i + 1].permute(0, 2, 3, 1) for i in range(len(kernels))]


def grad_layer(x, normal=None):
    """Sobel gradient magnitude, or the derivative along the normal.

    x: [B,H,W,1] (or [B,H,W,3], converted to gray); normal: optional
    [B,H,W,1] angle in radians in [-pi, pi].  Returns (magnitude, x_v, x_h).
    """
    if x.shape[-1] == 3:
        x = rgb_to_gray(x)
    if normal is None:
        x_v, x_h = _sobel3_bank(x, (SOBEL3_V, SOBEL3_H))
        return torch.sqrt(x_v ** 2 + x_h ** 2 + 1e-6), x_v, x_h

    x_v, x_h, x_lr, x_rl = _sobel3_bank(x, (SOBEL3_V, SOBEL3_H, SOBEL3_LR, SOBEL3_RL))
    pi = math.pi

    def in_range(lo, hi):
        return (normal >= lo) & (normal < hi)

    range_v = in_range(-5 * pi / 8, -3 * pi / 8) | in_range(3 * pi / 8, 5 * pi / 8)
    range_rl = in_range(-7 * pi / 8, -5 * pi / 8) | in_range(1 * pi / 8, 3 * pi / 8)
    range_lr = in_range(-3 * pi / 8, -1 * pi / 8) | in_range(5 * pi / 8, 7 * pi / 8)
    mag = torch.abs(x_h)
    mag = torch.where(range_v, torch.abs(x_v), mag)
    mag = torch.where(range_rl, torch.abs(x_rl), mag)
    mag = torch.where(range_lr, torch.abs(x_lr), mag)
    return mag, x_v, x_h


def class_balanced_bce(prob, gt_edge, gt_mask=None, pos_to_neg_weight=1.0):
    """Per-sample class-balanced weighted BCE (``grad_loss.py:129-166``).

    prob, gt_edge, gt_mask (optional): [B,H,W,1].  ``alpha`` always uses
    mask-weighted positive/negative counts, but the loss is masked and
    divided by ``mask.sum()`` only when the mask is exactly binary {0, 1}
    with both values present; any other mask (continuous, all ones, all
    zeros) gives the unmasked loss divided by ``numel``.  That test depends
    on the data, so it is a ``torch.where`` on a device boolean: no host
    sync.
    """
    numel = float(gt_edge.numel())
    mask = torch.ones_like(gt_edge) if gt_mask is None else gt_mask

    pos_loss = -gt_edge * torch.log(prob + 0.001)
    neg_mask = 1.0 - gt_edge
    neg_loss = -neg_mask * torch.log(1.0 - prob + 0.001)

    axes = (1, 2, 3)
    weights_pos = (gt_edge * mask).sum(axes)
    weights_neg = (neg_mask * mask).sum(axes)
    alpha = torch.where(weights_neg.sum() == 0, torch.ones_like(weights_neg),
                        weights_neg / torch.clamp(weights_pos + weights_neg, min=1e-12))

    if gt_mask is None:
        pos_eff, neg_eff, valid_pixels = pos_loss, neg_loss, max(numel, 1.0)
    else:
        is_binary = (((mask == 0) | (mask == 1)).all()
                     & (mask == 1).any() & (mask == 0).any())
        pos_eff = torch.where(is_binary, pos_loss * mask, pos_loss)
        neg_eff = torch.where(is_binary, neg_loss * mask, neg_loss)
        valid_pixels = torch.clamp(torch.where(is_binary, mask.sum(), numel), min=1.0)

    per_sample = pos_to_neg_weight * alpha * pos_eff.sum(axes) + \
        (1.0 - alpha) * neg_eff.sum(axes)
    return per_sample.sum() / valid_pixels


def attention_loss2(prob, target, mask=None, spatially_adaptive=False):
    """AF-style focal BCE (``attention_loss.py:21-49``); the focal weight
    carries no gradient."""
    eps = 1e-14
    if not spatially_adaptive:
        num_pos = (target == 1).sum().float()
        num_neg = (target == 0).sum().float()
        alpha = num_neg / torch.clamp(num_pos + num_neg, min=1.0)
    else:
        pos_alpha = box_filter_15(target) / 225.0
        neg_alpha = 1.0 - pos_alpha
        alpha = torch.where(neg_alpha >= 1.0 - eps, 0.5, neg_alpha)

    p = torch.clamp(prob, eps, 1.0 - eps)
    weight = target * alpha * torch.pow(4.0, torch.sqrt(1.0 - p)) + \
        (1.0 - target) * (1.0 - alpha) * torch.pow(4.0, torch.sqrt(p))
    weight = weight.detach()
    if mask is not None:
        weight = weight * mask
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return torch.mean(weight * bce)


def dice_loss(prob, gt_edge):
    """Inverse-dice term with the 1000x weight (``grad_loss.py:150-156``)."""
    numel = float(gt_edge.numel())
    return 1000.0 * ((torch.sum(prob ** 2) + torch.sum(gt_edge ** 2) + 1e-4) /
                     (2.0 * torch.sum(prob * gt_edge) + 1e-4)) / numel


def grad_loss(output, gt_edge, gt_mask=None, is_grad=True, is_sigmoid=True,
              sigmoid_thresh=4.0, gt_normals=None,
              edge_loss_type='cross_entropy', weight=1.0,
              pos_to_neg_weight=1.0):
    """GradLoss forward (``grad_loss.py:199-252``, reference ``:122-159``).

    output: [B,h,w,1] predicted depth (a probability when ``is_grad`` is
    False); gt_edge: [B,H,W,1].  Returns (loss, the detached gradient
    magnitude or ``output``).
    """
    gt_h, gt_w = gt_edge.shape[1], gt_edge.shape[2]
    if output.shape[1] != gt_h or output.shape[2] != gt_w:
        output = resize_bilinear(output, (gt_h, gt_w), align_corners=False)

    output_grad = grad_layer(output, gt_normals)[0] if is_grad else output
    if is_sigmoid:
        prob = 1.0 / (1.0 + torch.exp(-(output_grad - sigmoid_thresh)))
    else:
        prob = output_grad

    edge_loss = 0.0
    if 'cross_entropy' in edge_loss_type:
        edge_loss = class_balanced_bce(prob, gt_edge, gt_mask, pos_to_neg_weight)
    if 'attention_loss' in edge_loss_type:
        edge_loss = attention_loss2(prob, gt_edge, gt_mask, False)
    if 'spatially_adaptive' in edge_loss_type:
        edge_loss = attention_loss2(prob, gt_edge, gt_mask, True)
    if 'dice' in edge_loss_type:
        edge_loss = edge_loss + dice_loss(prob, gt_edge)
    return weight * torch.mean(torch.as_tensor(edge_loss)), output_grad.detach()
