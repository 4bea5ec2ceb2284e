"""The pinhole warp's geometry: the wrapper of ``csrc/warp_kernel.cu``.

``geometry/camera.view_synthesis`` samples a reference image at the
coordinates where each pixel of the original frame lands in the reference
camera, given the frame's depth [B,H,W,1], the intrinsics ``K`` and
``ref_K`` [B,3,3] and the pose [B,4,4] (original -> reference).  On the
card it takes those coordinates [B,H,W,2], normalised as
``align_corners=True`` reads them, from these kernels.  They replace no TPU
kernel: the plain version is ``camera.reconstruct`` + ``camera.project``,
which ``view_synthesis`` runs on the CPU, and whose backward sends the
pose's gradient through a 3x3 cuBLAS product over every pixel of the frame
(``geometry/pose.transform_points``).

* :func:`launch` and :func:`launch_backward` run the kernels on contiguous
  float32 CUDA tensors and raise on anything else.
* :class:`WarpCoordsFn` is the autograd: the forward saves the inputs, not
  the maps; the backward recomputes them and returns the depth's and the
  pose's gradients (the pose's bottom row 0).  ``K`` and ``ref_K`` take no
  gradient: it raises if either requires one.
* ``launches`` counts the forward's launches, and each adds 1 to the
  program's counter ``warp_kernel`` (``utils/profiling.count``).
"""

import ctypes
import functools

import torch

from mindtheedge_tpu_torch.ops.cuda import build
from mindtheedge_tpu_torch.utils.profiling import count

_MAX_PIXELS = 2 ** 31       # H * W, a pixel's int index in its frame
_MAX_FRAMES = 65535         # B, the kernels' grid.y

launches = 0


@functools.cache
def _kernel():
    lib = build.load('warp_kernel')
    forward = lib.mte_warp_coords
    forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    forward.restype = ctypes.c_int
    backward = lib.mte_warp_coords_backward
    backward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    backward.restype = ctypes.c_int
    blocks = lib.mte_warp_backward_blocks
    blocks.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    blocks.restype = ctypes.c_int
    lib.mte_warp_error_string.argtypes = [ctypes.c_int]
    lib.mte_warp_error_string.restype = ctypes.c_char_p
    return forward, backward, blocks, lib.mte_warp_error_string


def _check(depth, K, ref_K, pose):
    """Raise unless the kernel takes these inputs -> (B, H, W)."""
    if depth.ndim != 4 or depth.shape[-1] != 1:
        raise ValueError(f'expected depth [B,H,W,1], got {tuple(depth.shape)}')
    b, h, w, _ = depth.shape
    for name, t, shape in (('K', K, (b, 3, 3)), ('ref_K', ref_K, (b, 3, 3)),
                           ('pose', pose, (b, 4, 4))):
        if tuple(t.shape) != shape:
            raise ValueError(f'expected {name} {list(shape)}, got {tuple(t.shape)}')
    tensors = (depth, K, ref_K, pose)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f'warp kernel takes float32, got {[t.dtype for t in tensors]}')
    if any(t.device != depth.device for t in tensors):
        raise ValueError('warp kernel takes depth, K, ref_K and pose on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('warp kernel takes contiguous tensors')
    if not (h * w < _MAX_PIXELS and b <= _MAX_FRAMES):
        raise ValueError(f'warp kernel takes H * W < {_MAX_PIXELS} and B <= {_MAX_FRAMES}, '
                         f'got {tuple(depth.shape)}')
    if depth.device.type != 'cuda':
        raise ValueError(f'warp kernel takes CUDA tensors, got {depth.device}')
    return b, h, w


def _raise(err, what):
    if err:
        raise RuntimeError(f'warp_kernel {what} failed: {_kernel()[3](err).decode()} ({err})')


def launch(depth, K, ref_K, pose):
    """The forward kernel: contiguous float32 CUDA depth [B,H,W,1], K and
    ref_K [B,3,3], pose [B,4,4] -> coordinates [B,H,W,2]."""
    global launches
    b, h, w = _check(depth, K, ref_K, pose)
    out = torch.empty(b, h, w, 2, dtype=depth.dtype, device=depth.device)
    if out.numel() == 0:
        return out
    forward = _kernel()[0]
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = forward(depth.data_ptr(), K.data_ptr(), ref_K.data_ptr(), pose.data_ptr(),
                      out.data_ptr(), b, h, w, stream)
    _raise(err, 'launch')
    launches += 1
    count('warp_kernel', 1)
    return out


@functools.lru_cache(maxsize=256)
def _backward_blocks(device_index, b, h, w):
    """The blocks a frame of the backward's first pass for [b, h, w] on the
    current device, whose index is ``device_index``: the pass's scratch is
    [b, blocks, 12]."""
    blocks = ctypes.c_int(0)
    _raise(_kernel()[2](b, h, w, ctypes.byref(blocks)), 'occupancy query')
    return blocks.value


def launch_backward(grad, depth, K, ref_K, pose):
    """The backward kernels: the coordinates' gradient [B,H,W,2] and the
    forward's inputs -> (the depth's gradient [B,H,W,1], the pose's
    [B,4,4])."""
    b, h, w = _check(depth, K, ref_K, pose)
    if tuple(grad.shape) != (b, h, w, 2) or grad.dtype != depth.dtype or \
            grad.device != depth.device:
        raise ValueError(f'expected a float32 gradient [{b},{h},{w},2] on {depth.device}, '
                         f'got {grad.dtype} {tuple(grad.shape)} on {grad.device}')
    grad = grad.contiguous()
    if grad.data_ptr() % 8:         # float2 loads
        grad = grad.clone()
    grad_depth = torch.empty_like(depth)
    grad_pose = torch.zeros_like(pose)
    if grad_depth.numel() == 0:
        return grad_depth.zero_(), grad_pose
    backward = _kernel()[1]
    with torch.cuda.device(depth.device):
        blocks = _backward_blocks(depth.device.index, b, h, w)
        partial = torch.empty(b, blocks, 12, dtype=torch.float32, device=depth.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = backward(grad.data_ptr(), depth.data_ptr(), K.data_ptr(), ref_K.data_ptr(),
                       pose.data_ptr(), grad_depth.data_ptr(), grad_pose.data_ptr(),
                       partial.data_ptr(), blocks, b, h, w, stream)
    _raise(err, 'backward launch')
    return grad_depth, grad_pose


class WarpCoordsFn(torch.autograd.Function):
    """:func:`launch` forward, :func:`launch_backward` backward; gradients
    for ``depth`` and ``pose`` only."""

    @staticmethod
    def forward(ctx, depth, K, ref_K, pose):
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            raise ValueError('warp kernel computes no gradient for K or ref_K; '
                             'pass them without requires_grad')
        ctx.save_for_backward(depth, K, ref_K, pose)
        return launch(depth, K, ref_K, pose)

    @staticmethod
    def backward(ctx, grad):
        depth, K, ref_K, pose = ctx.saved_tensors
        grad_depth, grad_pose = launch_backward(grad, depth, K, ref_K, pose)
        return (grad_depth if ctx.needs_input_grad[0] else None, None, None,
                grad_pose if ctx.needs_input_grad[3] else None)

