"""Edge ops in plain PyTorch: counterpart of ``mindtheedge_tpu/ops/edge_ops.py``
(reference ``utils/tools.py:9-99``, ``infer_edge_estimation.py:194-199``):
Sobel-5, direction-quantised NMS, the Sobel-angle normal map, hysteresis and
isolated-edge removal.  These are XLA in the JAX package, not Pallas; only
the NMS has a hand-written CUDA kernel (``csrc/nms_kernel.cu``).

``non_max_suppression`` here is the plain version of the CUDA kernel
``csrc/nms_kernel.cu`` and its oracle.  The Sobel is computed as explicit
separable shifted sums, rows then columns, one rounded product and one
rounded add per tap, in fp32 on a reflect-101 pad: no convolution, so no
TF32 and no summation order chosen by a library.  The kernel repeats this
arithmetic in the same order, so the two give bit-equal Sobel responses.
"""

import math

import torch
import torch.nn.functional as F

# cv2 getDerivKernels(1, 0, 5): smooth = [1,4,6,4,1], deriv = [-1,-2,0,2,1]
SMOOTH5 = (1.0, 4.0, 6.0, 4.0, 1.0)
DERIV5 = (-1.0, -2.0, 0.0, 2.0, 1.0)
CHECK_EVERY = 4     # hysteresis dilation steps between host checks


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

    out = torch.where(keep & _interior(h, w, x.device), x, 0.0)
    return out.reshape(img.shape)


def _interior(h, w, device):
    """[H,W] bool: True off the 1-pixel border."""
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    return (row >= 1) & (row < h - 1) & (col >= 1) & (col < w - 1)


def normals_angle_255(img):
    """Sobel-angle normal map (``edge_ops.py:76-83``), float codes in
    [0, 255]: ``floor((atan2(-sy, sx) * 180/pi + 180) / 360 * 255)``.  Cast
    to uint8 on the host for writing.  Sobel sums rounded in another order
    can move a code by one, and near +-pi wrap it between 0 and 255."""
    sx, sy = sobel5_x(img), sobel5_y(img)
    angle = torch.atan2(-sy, sx)
    return torch.floor((angle * (180.0 / math.pi) + 180.0) / 360.0 * 255.0)


def decode_normal_png(v255):
    """Inverse of the uint8 ``normals_angle_255`` code: angle in radians
    (``edge_ops.py:86-91``, training-side ``gta_dataset.py:410-413``)."""
    return (v255 / 255.0) * 2 * math.pi - math.pi


def hysteresis(img, t_low=0.3, t_high=0.7, max_iters=None,
               check_every=CHECK_EVERY):
    """Hysteresis thresholding of [H,W] or [B,H,W] (``edge_ops.py:145-189``,
    reference ``utils/tools.py:49-92``); see :func:`hysteresis_counted`."""
    return hysteresis_counted(img, t_low, t_high, max_iters, check_every)[0]


def hysteresis_counted(img, t_low=0.3, t_high=0.7, max_iters=None,
                       check_every=CHECK_EVERY):
    """Hysteresis thresholding -> (output, iterations, checks).

    Interior pixels are labelled strong (> ``t_high``), weak (< ``t_low``)
    or intermediate; border pixels keep their raw values as labels (the
    reference's quirk).  Intermediate pixels 8-connected to strong ones
    become strong, to the fixpoint.  Then the remaining intermediates are
    zeroed, the labels are divided by their per-image max and multiplied
    into ``img``.

    The JAX package loops on the device until a step grows nothing, with
    ``max_iters`` (default H*W) as a backstop.  Here each ``.any()`` test on
    the host would wait for the card, so the loop runs ``check_every``
    dilation steps between tests: steps past the fixpoint change nothing,
    so the result is exact.  A device counter adds up the steps that grew;
    one host read of it per ``check_every`` steps says whether the fixpoint
    was reached.  ``iterations`` is the JAX loop's count (steps that grew,
    plus the one that did not, at most ``max_iters``); ``checks`` is the
    number of host reads.

    A step is six small launches on {0, 1} float masks, and on an H100 its
    host-side launch cost (~100-180 us) outweighs a check (~15-70 us;
    PERF.md), so ``check_every`` is small.
    """
    x = _batched(img)
    b, h, w = x.shape
    if max_iters is None:
        max_iters = h * w
    interior = _interior(h, w, x.device)
    labels = torch.where(x > t_high, 2.0, torch.where(x < t_low, 0.0, 1.0))
    labels = torch.where(interior, labels, x)

    # [B,1,H,W] masks in {0, 1}: strong pixels, and those that may still grow
    strong = (labels == 2.0).to(torch.float32)[:, None]
    cand0 = (labels == 1.0) & interior
    cand = cand0.to(torch.float32)[:, None]
    grown = torch.zeros((), dtype=torch.float64, device=x.device)
    steps = checks = n_grown = 0
    while steps < max_iters:
        for _ in range(min(check_every, max_iters - steps)):
            grow = F.max_pool2d(strong, 3, 1, padding=1).mul_(cand)
            strong.add_(grow)                            # grow lies in cand,
            cand.sub_(grow)                              # outside strong
            grown.add_(grow.amax())                      # 1 if it grew
            steps += 1
        checks += 1
        n_grown = int(grown)                             # waits for the card
        if n_grown < steps:                              # a step grew nothing
            break

    # grown intermediates -> 2, the rest of them -> 0, other labels unchanged
    labels = torch.where(cand0, torch.where(cand[:, 0] > 0, 0.0, 2.0), labels)
    denom = torch.clamp(labels.amax(dim=(1, 2), keepdim=True), min=1e-12)
    out = x * (labels / denom)
    return out.reshape(img.shape), min(n_grown + 1, max_iters), checks


def remove_isolated_edges(img):
    """== ``utils/tools.py:94-99`` (``edge_ops.py:192-202``): keep the
    pixels that are > 0 and whose zero-padded 3x3 sum is >= 2.  The sum is
    nine shifted adds in window order, not a convolution, so no TF32."""
    x = _batched(img)
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (1, 1, 1, 1))
    s = torch.zeros_like(x)
    for di in range(3):
        for dj in range(3):
            s = s + xp[:, di:di + h, dj:dj + w]
    out = ((s >= 2) & (x > 0)).to(torch.float32)
    return out.reshape(img.shape)
