"""Image utilities on NHWC tensors: counterpart of
``mindtheedge_tpu/utils/image.py:11-105``, with torch's interpolation
semantics where the losses and the metric protocol depend on them.

The resizes gather rows and columns by index and interpolate by the same
formulas as the JAX package, so gradients flow through them.
"""

import torch
import torch.nn.functional as F


def flip_lr(x):
    """Horizontal flip of [B,H,W,C] (reference ``utils/image.py`` flip_lr)."""
    return torch.flip(x, dims=(2,))


def gradient_x(x):
    """x[:, :, :-1] - x[:, :, 1:] over the width of [B,H,W,C] (``image.py:16-18``)."""
    return x[:, :, :-1] - x[:, :, 1:]


def gradient_y(x):
    """x[:, :-1] - x[:, 1:] over the height of [B,H,W,C] (``image.py:21-22``)."""
    return x[:, :-1] - x[:, 1:]


def rgb_to_gray(x):
    """ITU-R 601 luma as in the reference GradLayer (``grad_loss.py:56-63``)."""
    coeffs = torch.tensor([65.738, 129.057, 25.064], dtype=x.dtype,
                          device=x.device) / 256.0
    return (x * coeffs).sum(-1, keepdim=True)


def _nearest_indices(out_size, in_size, device):
    # torch 'nearest' semantics: src = floor(dst * in/out)
    idx = torch.floor(torch.arange(out_size, dtype=torch.float32, device=device)
                      * (in_size / out_size)).long()
    return torch.clamp(idx, 0, in_size - 1)


def resize_nearest(x, shape):
    """torch ``F.interpolate(mode='nearest')`` semantics on [B,H,W,C]."""
    h, w = shape
    iy = _nearest_indices(h, x.shape[1], x.device)
    ix = _nearest_indices(w, x.shape[2], x.device)
    return x.index_select(1, iy).index_select(2, ix)


def _linear_weights(out_size, in_size, align_corners, device, dtype=torch.float32):
    pos = torch.arange(out_size, dtype=dtype, device=device)
    if align_corners and out_size > 1:
        src = pos * ((in_size - 1) / (out_size - 1))
    else:
        src = (pos + 0.5) * (in_size / out_size) - 0.5
    src = torch.clamp(src, 0.0, in_size - 1)
    lo = torch.clamp(torch.floor(src).long(), 0, in_size - 1)
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    return lo, hi, src - lo


def resize_bilinear(x, shape, align_corners=False):
    """torch ``F.interpolate(mode='bilinear')`` on [B,H,W,C], both align
    modes, computed in fp32 (fp64 for fp64 input)."""
    h, w = int(shape[0]), int(shape[1])
    dtype = torch.promote_types(x.dtype, torch.float32)
    y_lo, y_hi, fy = _linear_weights(h, x.shape[1], align_corners, x.device, dtype)
    x_lo, x_hi, fx = _linear_weights(w, x.shape[2], align_corners, x.device, dtype)
    xf = x.to(dtype)
    top, bot = xf.index_select(1, y_lo), xf.index_select(1, y_hi)
    rows = top + (bot - top) * fy[None, :, None, None]
    left, right = rows.index_select(2, x_lo), rows.index_select(2, x_hi)
    out = left + (right - left) * fx[None, None, :, None]
    return out.to(x.dtype)


def interpolate_image(image, shape, mode='bilinear', align_corners=True):
    """Reference ``utils/image.py`` interpolate_image (NHWC)."""
    if image.shape[1] == shape[0] and image.shape[2] == shape[1]:
        return image
    if mode == 'nearest':
        return resize_nearest(image, shape)
    return resize_bilinear(image, shape, align_corners=bool(align_corners))


def match_scales(image, targets, num_scales, mode='nearest', align_corners=None):
    """``image`` resized to the first ``num_scales`` target resolutions,
    reused where the shapes already match (reference ``match_scales``)."""
    return [interpolate_image(image, (t.shape[1], t.shape[2]), mode=mode,
                              align_corners=align_corners)
            for t in targets[:num_scales]]


def box_filter_15(x):
    """15x15 ones-kernel sum with zero padding on [B,H,W,1]
    (``attention_loss.py:10-13,29``)."""
    k = torch.ones(1, 1, 15, 15, dtype=x.dtype, device=x.device)
    return F.conv2d(x.permute(0, 3, 1, 2), k, padding=7).permute(0, 2, 3, 1)
