"""Batched rigid transforms [B,4,4]: counterpart of
``mindtheedge_tpu/geometry/pose.py:9-69`` (reference ``geometry/pose.py``,
``geometry/pose_utils.py``)."""

import torch


def euler2mat(angle):
    """Euler angles [B,3] -> rotation matrices [B,3,3], R = X @ Y @ Z
    (``pose.py:9-30``, reference ``pose_utils.py:9-38``)."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    cosz, sinz = torch.cos(z), torch.sin(z)
    zmat = torch.stack([cosz, -sinz, zeros,
                        sinz, cosz, zeros,
                        zeros, zeros, ones], 1).reshape(-1, 3, 3)
    cosy, siny = torch.cos(y), torch.sin(y)
    ymat = torch.stack([cosy, zeros, siny,
                        zeros, ones, zeros,
                        -siny, zeros, cosy], 1).reshape(-1, 3, 3)
    cosx, sinx = torch.cos(x), torch.sin(x)
    xmat = torch.stack([ones, zeros, zeros,
                        zeros, cosx, -sinx,
                        zeros, sinx, cosx], 1).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def _homogenise(top):
    """[B,3,4] -> [B,4,4] with the bottom row (0, 0, 0, 1)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(top.shape[0], 1, 4)], 1)


def pose_vec2mat(vec, mode='euler'):
    """6-DoF vectors [B,6] (tx, ty, tz, rx, ry, rz) -> [B,4,4] transforms
    (``pose.py:33-45``; the reference returns [B,3,4]).  ``mode`` None
    returns ``vec`` as it is."""
    if mode is None:
        return vec
    return _homogenise(torch.cat([euler2mat(vec[:, 3:]), vec[:, :3, None]], 2))


def invert_pose(T):
    """Inverse of rigid [B,4,4] transforms (``pose.py:48-57``)."""
    Rt = T[:, :3, :3].transpose(-2, -1)
    return _homogenise(torch.cat([Rt, -Rt @ T[:, :3, 3:]], 2))


def identity_pose(batch, dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device).expand(batch, 4, 4)


def transform_points(T, points):
    """[B,4,4] applied to [B,H,W,3] point maps (``pose.py:64-69``,
    reference ``Pose.__matmul__``)."""
    b, h, w, _ = points.shape
    p = points.reshape(b, -1, 3) @ T[:, :3, :3].transpose(-2, -1) + T[:, None, :3, 3]
    return p.reshape(b, h, w, 3)
