"""The generic (ray-surface) camera: counterpart of
``mindtheedge_tpu/geometry/camera_generic.py:21-108`` (reference
``geometry/camera_generic.py``, TRI's Neural Ray Surfaces).

A network predicts a ray direction for each pixel.  ``reconstruct``:
P(x, y) = d(x, y) * r(x, y).  ``project``: each 3-D point is matched
against the rays of a (2r+1)^2 patch of the reference camera around the
point's own pixel, and its coordinate is the softmax-weighted mean of the
patch's pixels (a soft argmax) whose temperature anneals with training
progress (``camera_generic.py:85-207``).

The JAX package computes this in XLA, outside any Pallas kernel; here it is
plain PyTorch (a gather, a contraction, a softmax, ``grid_sample``).  Two
things differ from the JAX layout, not from its values:

* The patch indices are built on the device from ``torch.arange`` at each
  call, where the JAX package builds [N, K, 2] int64 coordinates with numpy
  on the host (3.3 GB at full width, N = 192 x 640, K = 41^2).  Each
  pixel's patch is its clamped start plus K fixed offsets
  (:func:`_patch_grid`), so the flat index is one broadcast add, int32.
* The ray-patch logits are one autograd function that gathers the
  [B, N, K, 3] patch rays in its forward and again in its backward,
  instead of saving them (2.5 GB per image and per call at full width):
  a step keeps the softmax weights [B, N, K] of each call alive, not the
  gathered rays.  Each logit is taken against the patch ray less the
  pixel's own ray (:class:`_PatchLogits`), which leaves the softmax as it
  is and rounds far less at a temperature of 1e-4.
"""

import torch

from mindtheedge_tpu_torch.geometry.camera import grid_sample
from mindtheedge_tpu_torch.geometry.pose import identity_pose, invert_pose, transform_points
from mindtheedge_tpu_torch.utils.image import resize_bilinear


def reconstruct_generic(depth, ray_surface, Tcw=None, frame='w'):
    """depth [B,H,W,1], ray_surface [B,H,W,3] -> points [B,H,W,3], in the
    camera frame (``frame='c'``) or the world's through ``Tcw``
    (``camera_generic.py:21-28``)."""
    Xc = ray_surface * depth
    if frame == 'c':
        return Xc
    if Tcw is None:
        Tcw = identity_pose(depth.shape[0], depth.dtype, depth.device)
    return transform_points(invert_pose(Tcw), Xc)


def _patch_grid(h, w, radius, device=None):
    """(start [h*w, 2], offset [K, 2]), int64 (row, column), K = (2r+1)^2:
    pixel n's patch is ``start[n] + offset``.  The patch is centred on the
    pixel and shifted whole inside the image where it would cross an edge,
    as ``camera_generic.py:31-46`` does: first up to row/column 0, then
    back to ``size - 1``."""
    def starts(size):
        return torch.clamp(torch.arange(size, device=device) - radius, min=0) \
            .clamp(max=size - 1 - 2 * radius)

    sy, sx = torch.meshgrid(starts(h), starts(w), indexing='ij')
    o = torch.arange(2 * radius + 1, device=device)
    oy, ox = torch.meshgrid(o, o, indexing='ij')
    return torch.stack([sy, sx], -1).reshape(-1, 2), torch.stack([oy, ox], -1).reshape(-1, 2)


def _flat_index(start, offset, w):
    """[N,K] int32 flat pixel index of each patch of :func:`_patch_grid`."""
    return (start[:, :1] * w + start[:, 1:]).int() + (offset[:, 0] * w + offset[:, 1]).int()


def _patch_coords(h, w, radius, device=None):
    """[h*w, K, 2] int64 patch coordinates (``camera_generic.py:31-46``)."""
    start, offset = _patch_grid(h, w, radius, device)
    return start[:, None] + offset[None]


class _PatchLogits(torch.autograd.Function):
    """Centred logits [B,N,K]: ``direction`` [B,N,3] dotted with
    ``rays[b, index[n, k]] - rays[b, n]`` (``rays`` [B,N,3], ``index``
    [N,K]), the ray patch of pixel n less its own ray.  The softmax over k
    does not see the shift; the rounding does: an uncentred logit lies
    near 1, where fp32's step of 6e-8 becomes 6e-4 over the temperature,
    and a centred one near 0.  The gathered [B,N,K,3] patch rays are made
    again in the backward, not saved."""

    @staticmethod
    def forward(ctx, direction, rays, index):
        ctx.save_for_backward(direction, rays, index)
        return torch.einsum('bnc,bnkc->bnk', direction, _centred_patches(rays, index))

    @staticmethod
    def backward(ctx, grad):
        direction, rays, index = ctx.saved_tensors
        grad_direction = grad_rays = None
        if ctx.needs_input_grad[0]:
            grad_direction = torch.einsum('bnk,bnkc->bnc', grad,
                                          _centred_patches(rays, index))
        if ctx.needs_input_grad[1]:
            b, n, k = grad.shape
            grad_rays = (-grad.sum(-1, keepdim=True) * direction).index_add_(
                1, index.reshape(-1),
                (grad[..., None] * direction[:, :, None, :]).reshape(b, n * k, 3))
        return grad_direction, grad_rays, None


def _centred_patches(rays, index):
    """rays [B,N,3] at ``index`` [N,K], less each pixel's own ray ->
    [B,N,K,3]."""
    patches = rays.index_select(1, index.reshape(-1)).view(
        rays.shape[0], *index.shape, rays.shape[-1])
    return patches - rays[:, :, None, :]


def project_generic(X, ray_surface, progress=0.0, Tcw=None, frame='c',
                    patch_radius=20, downsample=True,
                    min_temp=1e-8, start_temp=1e-4, constant=0.1):
    """Soft-argmax ray-surface projection of the points ``X`` [B,H,W,3]
    against ``ray_surface`` [B,H,W,3] -> grid coordinates [B,H,W,2] in
    [-1, 1], (x, y) order, for ``grid_sample`` (``camera_generic.py:49-96``).
    With ``downsample`` both are first resized to half size (bilinear,
    aligned corners) and the coordinates back to full size.  The
    temperature is ``max(min_temp, start_temp / exp(constant * progress))``
    (``progress`` a number or a 0-d tensor)."""
    b, H, W, _ = X.shape
    if frame == 'w' and Tcw is not None:
        X = transform_points(Tcw, X)
    rs = ray_surface
    h, w = (H // 2, W // 2) if downsample else (H, W)
    if downsample:
        rs = resize_bilinear(rs, (h, w), align_corners=True)
        X = resize_bilinear(X, (h, w), align_corners=True)
    rs = rs.to(X.dtype)     # a bf16 ray surface meets fp32 points, as JAX promotes
    if 2 * patch_radius + 1 > min(h, w):
        raise ValueError(f'a patch of radius {patch_radius} does not fit in {h}x{w}')

    start, offset = _patch_grid(h, w, patch_radius, X.device)
    index = _flat_index(start, offset, w)
    direction = X.reshape(b, h * w, 3)
    direction = direction / torch.clamp(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), min=1e-12)
    logits = _PatchLogits.apply(direction, rs.reshape(b, h * w, 3), index)
    progress = torch.as_tensor(progress, dtype=torch.float32, device=X.device)
    temperature = torch.clamp(start_temp / torch.exp(constant * progress), min=min_temp)
    weights = torch.softmax(logits / temperature, dim=-1)
    # sum_k w_k (start + offset_k) = start + sum_k w_k offset_k, the weights
    # summing to one
    expected = start.to(weights.dtype) + weights @ offset.to(weights.dtype)

    ynorm = (2 * expected[..., 0] / (h - 1) - 1.0).reshape(b, h, w, 1)
    xnorm = (2 * expected[..., 1] / (w - 1) - 1.0).reshape(b, h, w, 1)
    if downsample:
        ynorm = resize_bilinear(ynorm, (H, W), align_corners=True)
        xnorm = resize_bilinear(xnorm, (H, W), align_corners=True)
    return torch.cat([xnorm, ynorm], -1)


def view_synthesis_generic(ref_image, depth, ray_surface, ref_ray_surface,
                           pose, progress=0.0, padding_mode='zeros',
                           patch_radius=20):
    """``ref_image`` warped into the original frame through the ray
    surfaces (``camera_generic.py:99-108``, reference
    ``camera_utils.py:65-97``); ``pose`` [B,4,4] maps the original camera
    to the reference one."""
    world_points = transform_points(pose, reconstruct_generic(depth, ray_surface, frame='c'))
    coords = project_generic(world_points, ref_ray_surface, progress,
                             frame='c', patch_radius=patch_radius)
    return grid_sample(ref_image, coords, padding_mode=padding_mode)
