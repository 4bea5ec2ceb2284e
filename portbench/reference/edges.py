"""Plain depth-edge post-processing: the benchmark's reference.

A frozen copy of the published algorithms (MindTheEdge ``utils/tools.py``,
``infer_edge_estimation.py``): the cv2 Sobel-5 on a reflect-101 pad, the
direction-quantised non-maximum suppression, the Sobel-angle normal code
(of the training batches' normals), and the serving wire's uint16 depth.
"""

import math

import torch
import torch.nn.functional as F

SMOOTH5 = (1.0, 4.0, 6.0, 4.0, 1.0)
DERIV5 = (-1.0, -2.0, 0.0, 2.0, 1.0)
DEPTH_SCALE = 256.0     # uint16 depth at 1/256 m


def _pad101(x, p):
    return F.pad(x[:, None], (p, p, p, p), mode='reflect')[:, 0]


def _sep(xp, row_k, col_k):
    """Separable 5-tap correlation of a [B,H+4,W+4] pad: rows, then columns."""
    h, w = xp.shape[1] - 4, xp.shape[2] - 4
    acc = sum(k * xp[:, t:t + h, :] for t, k in enumerate(row_k) if k)
    return sum(k * acc[:, :, t:t + w] for t, k in enumerate(col_k) if k)


def sobel5(x):
    """(d/dx, d/dy) of [B,H,W], as cv2.Sobel ksize 5 with reflect-101."""
    xp = _pad101(x, 2)
    return _sep(xp, SMOOTH5, DERIV5), _sep(xp, DERIV5, SMOOTH5)


def interior(h, w, device):
    row = torch.arange(h, device=device)[:, None]
    col = torch.arange(w, device=device)[None, :]
    return (row >= 1) & (row < h - 1) & (col >= 1) & (col < w - 1)


def nms(x):
    """Direction-quantised NMS of [B,H,W]: the angle of the Sobel-5 gradient,
    folded into [0, 180), picks the neighbour pair (0, 45, 90 or 135 deg);
    a pixel off the 1-pixel border is kept iff it is >= both."""
    b, h, w = x.shape
    xp = _pad101(x, 2)
    sx, sy = _sep(xp, SMOOTH5, DERIV5), _sep(xp, DERIV5, SMOOTH5)
    angle = torch.rad2deg(torch.atan2(sy, sx))
    angle = torch.where(angle < 0, angle + 180.0, angle)

    def nb(di, dj):
        return xp[:, 2 + di:2 + di + h, 2 + dj:2 + dj + w]

    is45 = (angle >= 22.5) & (angle < 67.5)
    is90 = (angle >= 67.5) & (angle < 112.5)
    is135 = (angle >= 112.5) & (angle < 157.5)
    q = torch.where(is45, nb(-1, -1), torch.where(is90, nb(1, 0),
                    torch.where(is135, nb(1, -1), nb(0, 1))))
    r = torch.where(is45, nb(1, 1), torch.where(is90, nb(-1, 0),
                    torch.where(is135, nb(-1, 1), nb(0, -1))))
    keep = (x >= q) & (x >= r) & interior(h, w, x.device)
    return torch.where(keep, x, 0.0)


def normal_codes(x):
    """The Sobel-angle normal code of [B,H,W]:
    floor((atan2(-dy, dx) in degrees + 180) / 360 * 255), in [0, 255]."""
    sx, sy = sobel5(x)
    angle = torch.atan2(-sy, sx)
    return torch.floor((angle * (180.0 / math.pi) + 180.0) / 360.0 * 255.0)


def depth_units(inv_depth):
    """The exact uint16 wire value of a depth: 256 / clamp(inv, 1e-6), clipped
    to [0, 65535], before rounding."""
    depth = 1.0 / torch.clamp(inv_depth, min=1e-6)
    return torch.clamp(depth * DEPTH_SCALE, 0.0, 65535.0)
