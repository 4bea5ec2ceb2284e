"""The pack layers' 1-channel 3x3x3 conv: the wrapper of ``csrc/conv3d_kernel.cu``.

``Conv3dOverChannels`` (``ops/blocks.py``) computes [B,D,H,W] -> [B,d*D,H,W]:
the channels serve as depth, one input feature, ``d`` output features,
zero padding 1.  It replaces no TPU kernel: the plain version is
``F.conv3d`` (:func:`plain`), which cuDNN runs in a generic kernel.

* :func:`launch` runs the kernel on a CUDA tensor in float32 or bfloat16,
  NCHW-contiguous or channels-last (the bf16 networks' NHWC activations,
  ``ops/blocks.nhwc``), and returns the output in the input's layout; it
  raises on anything else; there is no fallback to the plain version.
* :class:`Conv3dOverChannelsFn` is its autograd: the forward launches the
  kernel and saves ``x`` and ``weight``, as autograd of ``F.conv3d`` does;
  the backward is ``aten.convolution_backward``, cuDNN's as before: for
  NCHW the call that autograd of ``F.conv3d`` makes, for channels-last the
  same conv with its axes in memory order (H, W, D) and channels-last-3d,
  so that cuDNN runs NDHWC and the input and its gradient need no copy (the
  output's gradient, [B,H,W,d,D] in memory, is copied once to cuDNN's
  [B,H,W,D,d]).  Under ``ops/remat.py`` the recompute launches the kernel
  again.
* ``launches`` counts the kernel's launches, and each launch adds 1 to the
  program's counter ``conv3d_kernel`` (``utils/profiling.count``).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops.cuda import build
from mindtheedge_tpu_torch.ops.packing import channels_last
from mindtheedge_tpu_torch.utils.profiling import count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FEATURES = (4, 8)
_MAX_SIDE = 2 ** 30         # H and W, so that row and column indices fit int32
_MAX_INT = 2 ** 31 - 1      # B and D, the C entry point's ints

launches = 0


@functools.cache
def _kernel():
    lib = build.load('conv3d_kernel')
    fn = lib.mte_conv3d_over_channels
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mte_conv3d_error_string.argtypes = [ctypes.c_int]
    lib.mte_conv3d_error_string.restype = ctypes.c_char_p
    return fn, lib.mte_conv3d_error_string


def plain(x, weight, bias):
    """The plain version: [B,D,H,W] -> [B,d*D,H,W] by ``F.conv3d``."""
    b, depth, h, w = x.shape
    return F.conv3d(x.unsqueeze(1), weight, bias, padding=1).reshape(b, -1, h, w)


def launch(x, weight, bias):
    """The kernel on a CUDA [B,D,H,W], NCHW-contiguous or channels-last, with
    ``weight`` [d,1,3,3,3] and ``bias`` [d] of its dtype, float32 or
    bfloat16, d in :data:`FEATURES` -> [B,d*D,H,W] in ``x``'s layout."""
    global launches
    if x.device.type != 'cuda':
        raise ValueError(f'conv3d kernel takes a CUDA tensor, got {x.device}')
    if x.dtype not in DTYPES:
        raise TypeError(f'conv3d kernel takes float32 or bfloat16, got {x.dtype}')
    if x.ndim != 4:
        raise ValueError(f'expected [B,D,H,W], got {tuple(x.shape)}')
    d = weight.shape[0]
    if d not in FEATURES or tuple(weight.shape) != (d, 1, 3, 3, 3):
        raise ValueError(f'conv3d kernel takes weight [d,1,3,3,3] with d in {FEATURES}, '
                         f'got {tuple(weight.shape)}')
    if tuple(bias.shape) != (d,):
        raise ValueError(f'expected bias [{d}], got {tuple(bias.shape)}')
    if any(p.dtype != x.dtype or p.device != x.device for p in (weight, bias)):
        raise TypeError('conv3d kernel takes weight and bias of the input\'s dtype and device')
    nhwc = channels_last(x)
    if not (weight.is_contiguous() and bias.is_contiguous() and (nhwc or x.is_contiguous())):
        raise ValueError('conv3d kernel takes contiguous weight and bias and an input '
                         'NCHW-contiguous or channels-last')
    b, depth, h, w = x.shape
    if not (h < _MAX_SIDE and w < _MAX_SIDE and depth < _MAX_SIDE and b <= _MAX_INT):
        raise ValueError(f'conv3d kernel takes H, W, D < {_MAX_SIDE} and B <= {_MAX_INT}, '
                         f'got {tuple(x.shape)}')
    out = (torch.empty(b, h, w, d * depth, dtype=x.dtype, device=x.device).permute(0, 3, 1, 2)
           if nhwc else torch.empty(b, d * depth, h, w, dtype=x.dtype, device=x.device))
    if out.numel() == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 DTYPES[x.dtype], d, int(nhwc), b, depth, h, w, stream)
    if err:
        raise RuntimeError(f'conv3d_kernel launch failed: {err_str(err).decode()} ({err})')
    launches += 1
    count('conv3d_kernel', 1)
    return out


class Conv3dOverChannelsFn(torch.autograd.Function):
    """:func:`launch` forward, ``F.conv3d``'s backward."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.nhwc = channels_last(x)
        return launch(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        b, depth, h, w = x.shape
        d = weight.shape[0]
        args = [d], [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1, list(ctx.needs_input_grad)
        if not ctx.nhwc:
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad.reshape(b, d, depth, h, w), x.unsqueeze(1), weight, *args)
            return None if gx is None else gx.squeeze(1), gw, gb
        # the axes (H, W, D): x [B,1,H,W,D] laid out channels-last-3d (its
        # memory as it is), so that cuDNN runs its NDHWC kernels and returns
        # the input's gradient in that layout; the output's gradient
        # [B,d,H,W,D] is copied to it once
        x5 = x.permute(0, 2, 3, 1).unsqueeze(-1).permute(0, 4, 1, 2, 3)
        grad = grad.permute(0, 2, 3, 1).reshape(b, h, w, d, depth).permute(0, 3, 1, 2, 4)
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x5, weight.permute(0, 1, 3, 4, 2), *args)
        return (None if gx is None else gx.squeeze(1).permute(0, 3, 1, 2),
                None if gw is None else gw.permute(0, 1, 4, 2, 3), gb)
