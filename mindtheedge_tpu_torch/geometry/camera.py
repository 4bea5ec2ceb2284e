"""Pinhole camera and view synthesis on NHWC tensors: counterpart of
``mindtheedge_tpu/geometry/camera.py:13-124`` (reference
``geometry/camera.py``, ``geometry/camera_utils.py``).

The JAX package samples with its own gather-based bilinear sampler; here
it is ``F.grid_sample`` (bilinear, ``align_corners=True``, zeros or border
padding), which computes the same values.  Its gradient with respect to the
coordinates is piecewise linear in both, and at integer coordinates the two
may take different one-sided derivatives.
"""

import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.geometry.pose import invert_pose, transform_points
from mindtheedge_tpu_torch.utils.profiling import count, span


def scale_intrinsics(K, x_scale, y_scale):
    """[B,3,3] intrinsics of an image resized by (x, y), with the +0.5
    pixel-centre convention (``camera.py:13-19``, reference
    ``camera_utils.py:17-23``)."""
    K = K.clone()
    K[..., 0, 0] *= x_scale
    K[..., 1, 1] *= y_scale
    K[..., 0, 2] = (K[..., 0, 2] + 0.5) * x_scale - 0.5
    K[..., 1, 2] = (K[..., 1, 2] + 0.5) * y_scale - 0.5
    return K


def invert_intrinsics(K):
    """Closed-form pinhole K^-1 (``camera.py:22-31``)."""
    fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    Kinv = K.clone()
    Kinv[:, 0, 0] = 1.0 / fx
    Kinv[:, 1, 1] = 1.0 / fy
    Kinv[:, 0, 2] = -cx / fx
    Kinv[:, 1, 2] = -cy / fy
    return Kinv


def image_grid(b, h, w, dtype=torch.float32, device=None):
    """Homogeneous pixel grid [B,H,W,3], (x, y, 1) per pixel."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing='ij')
    return torch.stack([xs, ys, torch.ones_like(xs)], -1).expand(b, h, w, 3)


def _apply_matrix(M, points):
    """[B,3,3] applied to [B,H,W,3] points (``einsum('bij,bhwj->bhwi')``)."""
    b, h, w, _ = points.shape
    return (points.reshape(b, -1, 3) @ M.transpose(1, 2)).reshape(b, h, w, 3)


def reconstruct(depth, K, Tcw=None, frame='w'):
    """Depth [B,H,W,1] -> 3D points [B,H,W,3] (``camera.py:44-58``); the
    world frame applies the inverse of the camera pose ``Tcw``, which the
    JAX package takes as the identity when it is None (then skipped here:
    the product is exact)."""
    b, h, w, _ = depth.shape
    grid = image_grid(b, h, w, depth.dtype, depth.device)
    Xc = _apply_matrix(invert_intrinsics(K.to(depth.dtype)), grid) * depth
    if frame == 'c' or Tcw is None:
        return Xc
    return transform_points(invert_pose(Tcw), Xc)


def project(X, K, Tcw=None, frame='w'):
    """3D points [B,H,W,3] -> grid coordinates [B,H,W,2] normalised to
    [-1, 1] by (W-1)/(H-1), as ``align_corners=True`` reads them; Z clipped
    at 1e-5 (``camera.py:61-74``)."""
    b, h, w, _ = X.shape
    if frame == 'w' and Tcw is not None:
        X = transform_points(Tcw, X)
    Xc = _apply_matrix(K.to(X.dtype), X)
    Z = torch.clamp(Xc[..., 2], min=1e-5)
    Xn = 2 * (Xc[..., 0] / Z) / (w - 1) - 1.0
    Yn = 2 * (Xc[..., 1] / Z) / (h - 1) - 1.0
    return torch.stack([Xn, Yn], -1)


def grid_sample(image, coords, padding_mode='zeros'):
    """Bilinear sampling of [B,H,W,C] at [B,H',W',2] coordinates in [-1, 1]
    ((x, y) order), ``align_corners=True``, zeros or border padding
    (``camera.py:77-113``)."""
    out = F.grid_sample(image.permute(0, 3, 1, 2), coords, mode='bilinear',
                        padding_mode=padding_mode, align_corners=True)
    return out.permute(0, 2, 3, 1)


def view_synthesis(ref_image, depth, ref_K, K, pose, padding_mode='zeros'):
    """``ref_image`` warped into the original frame (``camera.py:116-124``,
    reference ``camera_utils.py:28-60``); ``pose`` [B,4,4] maps the
    original camera to the reference one.  A call is the span
    ``mte.train.warp`` and adds 1 to the counter ``view_synthesis``."""
    with span('mte.train.warp'):
        count('view_synthesis', 1)
        world_points = reconstruct(depth, K, Tcw=None, frame='w')
        ref_coords = project(world_points, ref_K, Tcw=pose, frame='w')
        return grid_sample(ref_image, ref_coords, padding_mode=padding_mode)
