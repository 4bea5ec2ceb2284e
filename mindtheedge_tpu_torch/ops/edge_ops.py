"""Sobel-5 and direction-quantised NMS in plain PyTorch: counterpart of
``mindtheedge_tpu/ops/edge_ops.py:25-41, 94-134`` (reference
``utils/tools.py:9-46``).

``non_max_suppression`` here is the plain version of the CUDA kernel
``csrc/nms_kernel.cu`` and its oracle.  The Sobel is computed as explicit
separable shifted sums, rows then columns, one rounded product and one
rounded add per tap, in fp32 on a reflect-101 pad: no convolution, so no
TF32 and no summation order chosen by a library.  The kernel repeats this
arithmetic in the same order, so the two give bit-equal Sobel responses.
"""

import torch
import torch.nn.functional as F

# cv2 getDerivKernels(1, 0, 5): smooth = [1,4,6,4,1], deriv = [-1,-2,0,2,1]
SMOOTH5 = (1.0, 4.0, 6.0, 4.0, 1.0)
DERIV5 = (-1.0, -2.0, 0.0, 2.0, 1.0)


def _reflect101_pad(img, p):
    """cv2 BORDER_REFLECT_101 pad of [B,H,W] by p (needs H, W > p)."""
    return F.pad(img[:, None], (p, p, p, p), mode='reflect')[:, 0]


def _sobel_sep(xp, row_k, col_k):
    """Separable 5-tap correlation of a [B,H+4,W+4] pad -> [B,H,W]:
    ``row_k`` along H first, then ``col_k`` along W; zero taps skipped."""
    h, w = xp.shape[1] - 4, xp.shape[2] - 4
    acc = None
    for t, k in enumerate(row_k):
        if k != 0.0:
            term = k * xp[:, t:t + h, :]
            acc = term if acc is None else acc + term
    out = None
    for t, k in enumerate(col_k):
        if k != 0.0:
            term = k * acc[:, :, t:t + w]
            out = term if out is None else out + term
    return out


def _batched(img):
    if img.ndim not in (2, 3):
        raise ValueError(f'expected [H,W] or [B,H,W], got {tuple(img.shape)}')
    return img[None] if img.ndim == 2 else img


def sobel5_x(img):
    """== cv2.Sobel(img, CV_64F, 1, 0, ksize=5), reflect-101, in fp32."""
    x = _batched(img)
    out = _sobel_sep(_reflect101_pad(x, 2), SMOOTH5, DERIV5)
    return out.reshape(img.shape)


def sobel5_y(img):
    """== cv2.Sobel(img, CV_64F, 0, 1, ksize=5), reflect-101, in fp32."""
    x = _batched(img)
    out = _sobel_sep(_reflect101_pad(x, 2), DERIV5, SMOOTH5)
    return out.reshape(img.shape)


def non_max_suppression(img):
    """Direction-quantised NMS of [H,W] or [B,H,W] (``edge_ops.py:94-134``).

    The gradient angle atan2(sy, sx), folded into [0, 180), picks one of
    four neighbour pairs (0/45/90/135 deg); a pixel is kept iff it is >= both
    neighbours (ties keep it) and lies off the 1-pixel border.  A flat pixel
    (sx = sy = 0) has angle 0 and takes the horizontal pair.
    """
    x = _batched(img)
    h, w = x.shape[1], x.shape[2]
    xp = _reflect101_pad(x, 2)
    sx = _sobel_sep(xp, SMOOTH5, DERIV5)
    sy = _sobel_sep(xp, DERIV5, SMOOTH5)
    angle = torch.rad2deg(torch.atan2(sy, sx))
    angle = torch.where(angle < 0, angle + 180.0, angle)

    def nb(di, dj):
        return xp[:, 2 + di:2 + di + h, 2 + dj:2 + dj + w]

    is45 = (angle >= 22.5) & (angle < 67.5)
    is90 = (angle >= 67.5) & (angle < 112.5)
    is135 = (angle >= 112.5) & (angle < 157.5)
    q = torch.where(is45, nb(-1, -1), torch.where(
        is90, nb(1, 0), torch.where(is135, nb(1, -1), nb(0, 1))))
    r = torch.where(is45, nb(1, 1), torch.where(
        is90, nb(-1, 0), torch.where(is135, nb(-1, 1), nb(0, -1))))
    keep = (x >= q) & (x >= r)

    row = torch.arange(h, device=x.device)[:, None]
    col = torch.arange(w, device=x.device)[None, :]
    interior = (row >= 1) & (row < h - 1) & (col >= 1) & (col < w - 1)
    out = torch.where(keep & interior, x, 0.0)
    return out.reshape(img.shape)
