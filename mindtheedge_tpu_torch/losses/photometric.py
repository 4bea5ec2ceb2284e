"""Self-supervised multi-view photometric loss: counterpart of
``mindtheedge_tpu/losses/photometric.py:16-115`` (reference
``losses/multiview_photometric_loss.py``).

Per scale, each context image is warped into the target frame by the
predicted depth and pose; the loss is SSIM + L1, reduced over the contexts
by their minimum (with the unwarped contexts as automask candidates) or
their mean, plus edge-aware smoothness of the mean-normalised inverse
depth.  NHWC at the boundary.

The minimum is ``torch.amin``, which splits the gradient evenly among tied
minima as JAX's ``min`` does (``torch.min(dim)`` would send all of it to
one index).  ``clip_loss`` uses the population standard deviation
(``correction=0``), JAX's ``std``.
"""

import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.geometry.camera import scale_intrinsics, view_synthesis
from mindtheedge_tpu_torch.utils.depth import inv2depth
from mindtheedge_tpu_torch.utils.image import gradient_x, gradient_y, match_scales


def _avg_pool3_reflect(x):
    """ReflectionPad(1) + AvgPool2d(3, stride 1) of NCHW ``x``
    (``photometric.py:16-23``)."""
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode='reflect'), 3, stride=1)


def ssim(x, y, C1=1e-4, C2=9e-4):
    """SSIM map of [B,H,W,C] images (``photometric.py:26-37``).  The five
    3x3 means run as one pooling over the stacked channels."""
    c = x.shape[-1]
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    mu_x, mu_y, e_x2, e_y2, e_xy = _avg_pool3_reflect(
        torch.cat([x, y, x * x, y * y, x * y], 1)).split(c, 1)
    mu_xy = mu_x * mu_y
    mu_x2, mu_y2 = mu_x ** 2, mu_y ** 2
    v1 = 2 * (e_xy - mu_xy) + C2
    v2 = (e_x2 - mu_x2) + (e_y2 - mu_y2) + C2
    out = ((2 * mu_xy + C1) * v1) / ((mu_x2 + mu_y2 + C1) * v2)
    return out.permute(0, 2, 3, 1)


def calc_smoothness(inv_depths, images, num_scales):
    """Edge-aware smoothness terms (``photometric.py:40-52``, reference
    ``utils/depth.py:166-199``) -> (x terms, y terms), one per scale."""
    sx, sy = [], []
    for i in range(num_scales):
        d = inv_depths[i]
        norm = d / torch.clamp(d.mean((1, 2), keepdim=True), min=1e-6)
        wx = torch.exp(-gradient_x(images[i]).abs().mean(-1, keepdim=True))
        wy = torch.exp(-gradient_y(images[i]).abs().mean(-1, keepdim=True))
        sx.append(gradient_x(norm) * wx)
        sy.append(gradient_y(norm) * wy)
    return sx, sy


def multiview_photometric_loss(
        image, context, inv_depths, K, ref_K, poses,
        num_scales=4, ssim_loss_weight=0.85, smooth_loss_weight=0.001,
        C1=1e-4, C2=9e-4, photometric_reduce_op='min', clip_loss=0.0,
        padding_mode='zeros', automask_loss=True):
    """The photometric loss (``photometric.py:55-115``, reference
    ``multiview_photometric_loss.py:289-346``) -> (loss, metrics).

    image [B,H,W,3]; context: [B,H,W,3] each; inv_depths: [B,h,w,1] each;
    K, ref_K [B,3,3]; poses: [B,4,4] each, original -> context.
    """
    if photometric_reduce_op not in ('min', 'mean'):
        raise NotImplementedError(photometric_reduce_op)
    n = num_scales
    W = image.shape[2]
    images = match_scales(image, inv_depths, n)
    depths = [inv2depth(inv_depths[i]) for i in range(n)]

    def photo(t_est, img):
        l1 = (t_est - img).abs()
        if ssim_loss_weight > 0:
            s = torch.clamp((1.0 - ssim(t_est, img, C1, C2)) / 2.0, 0.0, 1.0)
            pl = ssim_loss_weight * s.mean(-1, keepdim=True) + \
                (1 - ssim_loss_weight) * l1.mean(-1, keepdim=True)
        else:
            pl = l1
        if clip_loss > 0:
            mean, std = pl.mean(), pl.std(correction=0)
            pl = torch.clamp(pl, max=mean + clip_loss * std)
        return pl

    losses = [[] for _ in range(n)]
    for ref_image, pose in zip(context, poses):
        ref_images = match_scales(ref_image, inv_depths, n)
        for i in range(n):
            scale = inv_depths[i].shape[2] / float(W)
            Ki = scale_intrinsics(K.float(), scale, scale)
            ref_Ki = scale_intrinsics(ref_K.float(), scale, scale)
            warped = view_synthesis(ref_images[i], depths[i], ref_Ki, Ki, pose,
                                    padding_mode=padding_mode)
            losses[i].append(photo(warped, images[i]))
            if automask_loss:
                losses[i].append(photo(ref_images[i], images[i]))

    def reduce(scale_losses):
        if photometric_reduce_op == 'mean':
            return sum(l.mean() for l in scale_losses) / len(scale_losses)
        return torch.amin(torch.cat(scale_losses, -1), -1).mean()

    loss = sum(reduce(losses[i]) for i in range(n)) / n
    metrics = {'photometric_loss': loss}
    if smooth_loss_weight > 0:
        sx, sy = calc_smoothness(inv_depths, images, n)
        smooth = sum((sx[i].abs().mean() + sy[i].abs().mean()) / 2 ** i
                     for i in range(n)) / n
        smooth = smooth_loss_weight * smooth
        metrics['smoothness_loss'] = smooth
        loss = loss + smooth
    return loss, metrics
