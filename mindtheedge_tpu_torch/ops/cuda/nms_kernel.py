"""Fused Sobel-5 + NMS: the wrapper of ``csrc/nms_kernel.cu``.

Counterpart of ``mindtheedge_tpu/ops/pallas/nms_kernel.py``.  A CUDA tensor
launches the kernel, or raises; a CPU tensor takes the plain version
``ops/edge_ops.non_max_suppression``.  There is no fallback from the one to
the other.  ``launches`` counts the kernel's launches.
"""

import ctypes
import functools

import torch

from mindtheedge_tpu_torch.ops import edge_ops
from mindtheedge_tpu_torch.ops.cuda import build

launches = 0
_MAX_SIDE = 2 ** 30         # H and W, so that column and row indices fit int32
_MAX_BATCH = 2 ** 31 - 1    # the C entry point's int


@functools.cache
def _kernel():
    lib = build.load('nms_kernel')
    fn = lib.mte_nms_sobel5
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mte_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mte_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.mte_cuda_error_string


def non_max_suppression(img):
    """Direction-quantised NMS of a float32 [H,W] or [B,H,W] edge probability
    (H, W >= 3); same semantics as ``edge_ops.non_max_suppression``."""
    global launches
    if img.device.type == 'cpu':
        return edge_ops.non_max_suppression(img)
    if img.device.type != 'cuda':
        raise ValueError(f'no NMS for device {img.device}')
    if img.dtype != torch.float32:
        raise TypeError(f'NMS kernel takes float32, got {img.dtype}')
    if img.ndim not in (2, 3):
        raise ValueError(f'expected [H,W] or [B,H,W], got {tuple(img.shape)}')
    if not img.is_contiguous():
        raise ValueError('NMS kernel takes a contiguous tensor')
    h, w = img.shape[-2:]
    batch = img.shape[0] if img.ndim == 3 else 1
    if not (3 <= h < _MAX_SIDE and 3 <= w < _MAX_SIDE) or batch > _MAX_BATCH:
        raise ValueError(f'NMS kernel takes 3 <= H, W < {_MAX_SIDE} and '
                         f'B <= {_MAX_BATCH}, got {tuple(img.shape)}')
    out = torch.empty_like(img)
    if batch == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), out.data_ptr(), batch, h, w, stream)
    if err:
        raise RuntimeError(
            f'nms_kernel launch failed: {err_str(err).decode()} ({err})')
    launches += 1
    return out
