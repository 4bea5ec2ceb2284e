"""Batched Canny edges for every threshold pair at once: the port's
counterpart of ``mindtheedge_tpu/ops/canny.py`` (XLA there, plain PyTorch
here; no kernel of its own).

The reference calls ``cv2.Canny`` on the host per image and threshold, 12
times an image in the edge-AUC sweep (``eval_depth_edges.py:264-280``);
:func:`canny_sweep` computes the whole sweep over a batch in one call, on
whatever device the images lie on.

cv2.Canny's steps, as the JAX op takes them: a 3x3 Sobel with a
reflect-101 border, the L1 magnitude ``|gx| + |gy|`` (cv2's default), a
4-bucket NMS (the ``atan2`` angle in degrees folded into [0, 180), the
bucket's two neighbours compared without interpolation, the 1-pixel
border zeroed), then for each threshold pair the strong (> high) and weak
(> low) masks and hysteresis by 8-neighbour dilation to a fixpoint.  Ties
in cv2's own NMS may break otherwise (``tests/test_canny.py`` holds the
JAX op within 3 % of cv2's pixels).

The images are uint8-range integers, whose Sobel sums are exact in fp32
and in TF32 alike, so the card's convs give the CPU's gradients; the
``atan2`` buckets may still part at a boundary by an ulp.
"""

import torch

from mindtheedge_tpu_torch.ops.edge_ops import (
    CHECK_EVERY, SOBEL3_H, SOBEL3_V, _interior, conv2_single)


def canny(img, low, high, max_iters=None, check_every=CHECK_EVERY):
    """Canny edges of [B,H,W] (or [H,W]) uint8-range images -> {0, 1}
    float maps; see :func:`canny_counted`."""
    return canny_counted(img, low, high, max_iters, check_every)[0]


def canny_counted(img, low, high, max_iters=None, check_every=CHECK_EVERY):
    """Canny edges (``canny.py:26-97``) -> (maps, dilation steps, host
    checks).

    ``low``/``high``: scalars, giving [B,H,W] maps, or [T] vectors, giving
    [T,B,H,W] (a 2-D image drops its batch dimension either way).  The T
    pairs are stacked in the batch dimension and dilated together, each map
    to its own fixpoint: a step past a map's fixpoint leaves it as it is,
    so running every map until the last is done is exact, as the JAX
    package's ``vmap`` of one ``while_loop`` a pair is.  A step is
    ``dilate8(current) & weak`` on boolean masks (the JAX op's ``min`` of
    {0, 1} floats, at a quarter of the bytes) from the strong mask; the
    loop runs ``check_every`` steps between host reads of a device counter
    of the steps that changed a map (as ``edge_ops.hysteresis_counted``), with
    ``max_iters`` (default H*W) as a backstop.  ``steps`` is the JAX loop's
    count: the steps that changed a map, plus the one that did not, at
    most ``max_iters``.
    """
    squeeze = img.dim() == 2
    x = (img[None] if squeeze else img).to(torch.float32)
    b, h, w = x.shape
    if max_iters is None:
        max_iters = h * w
    gx, gy = conv2_single(x, SOBEL3_H), conv2_single(x, SOBEL3_V)
    mag = gx.abs() + gy.abs()

    angle = torch.rad2deg(torch.atan2(gy, gx))
    angle = torch.where(angle < 0, angle + 180.0, angle)
    shift = lambda di, dj: torch.roll(mag, (-di, -dj), dims=(1, 2))
    is45 = (angle >= 22.5) & (angle < 67.5)
    is90 = (angle >= 67.5) & (angle < 112.5)
    is135 = (angle >= 112.5) & (angle < 157.5)
    q = torch.where(is45, shift(-1, 1), torch.where(
        is90, shift(1, 0), torch.where(is135, shift(1, 1), shift(0, 1))))
    r = torch.where(is45, shift(1, -1), torch.where(
        is90, shift(-1, 0), torch.where(is135, shift(-1, -1), shift(0, -1))))
    nms = torch.where((mag >= q) & (mag >= r) & _interior(h, w, x.device), mag, 0.0)

    scalar = torch.as_tensor(low).dim() == 0
    as_vector = lambda t: torch.as_tensor(t, dtype=torch.float32,
                                          device=x.device).reshape(-1, 1, 1, 1)
    lo, hi = as_vector(low), as_vector(high)
    n = max(lo.shape[0], hi.shape[0])
    cur = (nms > hi).expand(n, b, h, w).reshape(n * b, h, w)
    weak = (nms > lo).expand(n, b, h, w).reshape(n * b, h, w)
    changed = torch.zeros((), dtype=torch.float64, device=x.device)
    steps = checks = n_changed = 0
    while steps < max_iters:
        for _ in range(min(check_every, max_iters - steps)):
            grown = _dilate8(cur).logical_and_(weak)
            changed.add_((grown != cur).any())
            cur = grown
            steps += 1
        checks += 1
        n_changed = int(changed)                        # waits for the card
        if n_changed < steps:                           # a step changed nothing
            break

    out = cur.reshape(n, b, h, w).to(torch.float32)
    if scalar and n == 1:
        out = out[0]
    if squeeze:
        out = out[:, 0] if out.dim() == 4 else out[0]
    return out, min(n_changed + 1, max_iters), checks


def _dilate8(m):
    """8-neighbour dilation of the boolean masks [N,H,W], zeros beyond the
    border (the JAX package's ``edge_ops._dilate8``, a ``reduce_window``
    max): the rows' 3-wide OR, then the columns'."""
    rows = m.clone()
    rows[..., 1:] |= m[..., :-1]
    rows[..., :-1] |= m[..., 1:]
    out = rows.clone()
    out[..., 1:, :] |= rows[..., :-1, :]
    out[..., :-1, :] |= rows[..., 1:, :]
    return out


def canny_sweep(img, thresholds, max_iters=None):
    """Canny at (t/2, t) for every t of ``thresholds`` (``canny.py:100-104``):
    the AUC sweep (``eval_depth_edges.py:264,279-280``) in one call ->
    [T,B,H,W]."""
    t = torch.as_tensor(thresholds, dtype=torch.float32)
    return canny(img, t / 2.0, t, max_iters)
