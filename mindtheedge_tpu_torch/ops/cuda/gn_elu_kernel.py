"""GroupNorm(16) + ELU over NHWC bfloat16: the wrapper of ``csrc/gn_elu_kernel.cu``.

Every ``ConvBlock`` and ``ResidualConv`` of the PackNet networks ends in
``ELU(GroupNorm(16))`` (``ops/blocks.GroupNorm.elu``).  On the NHWC path
(``ops/blocks.nhwc``: bf16 activations on the card, an unsharded block) it
is this kernel pair, since ATen's CUDA GroupNorm reads NCHW only.  It
replaces no TPU kernel: the plain version is ``F.elu(F.group_norm(x))``
(:func:`plain`), which the tests hold it to.

* :func:`launch` and :func:`launch_backward` run the kernels on
  channels-last bfloat16 CUDA tensors and raise on anything else; there is
  no fallback to the plain version.
* :class:`GroupNormEluFn` is the autograd: the forward saves the input, the
  mean and rstd [B,16] (fp32) and the output, as autograd of
  ``F.elu(F.group_norm(x))`` saves them, and its backward is the second
  kernel chain.
* :func:`plain_forward` and :func:`plain_backward` compute what the kernels
  compute in plain PyTorch (fp32 statistics and sums, one rounding of the
  output), so the CPU tests can hold the Function's arithmetic to autograd
  of the plain version.
* ``launches`` counts the forward's launches, and each adds 1 to the
  program's counter ``gn_elu_kernel`` (``utils/profiling.count``).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops.cuda import build
from mindtheedge_tpu_torch.utils.profiling import count

GROUPS = 16
_THREADS = 256              # the kernels' streaming blocks, at most
_MIN_ROUNDS = 4             # pixel rounds a thread, at least
_BLOCKS_PER_SM = 16         # the grid: two waves of 8 resident blocks
_MAX_CHANNELS = 2048
_MAX_BATCH = 65535          # the grid's y

launches = 0


@functools.cache
def _kernel():
    lib = build.load('gn_elu_kernel')
    forward = lib.mte_gn_elu_forward
    forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    forward.restype = ctypes.c_int
    backward = lib.mte_gn_elu_backward
    backward.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                                   ctypes.c_int, ctypes.c_void_p])
    backward.restype = ctypes.c_int
    lib.mte_gn_elu_error_string.argtypes = [ctypes.c_int]
    lib.mte_gn_elu_error_string.restype = ctypes.c_char_p
    return forward, backward, lib.mte_gn_elu_error_string


def supported(channels):
    """Whether the kernels take ``channels``: a multiple of 16 up to 2048
    whose groups of ``channels / 16`` fill or split a 16-byte vector
    evenly (``channels / 16`` in {1, 2, 4} or a multiple of 8)."""
    cg, rest = divmod(channels, GROUPS)
    return not rest and 0 < channels <= _MAX_CHANNELS and (cg in (1, 2, 4) or cg % 8 == 0)


@functools.lru_cache(maxsize=None)
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _tiles(batch, pixels, channels, sms):
    """Pixel tiles an image: each thread reads at least ``_MIN_ROUNDS``
    vectors, and the grid holds at most ``_BLOCKS_PER_SM`` blocks an SM."""
    lanes = _THREADS // (channels // 8)
    return max(1, min(-(-pixels // (lanes * _MIN_ROUNDS)), -(-_BLOCKS_PER_SM * sms // batch)))


def plain(x, weight, bias, eps=1e-5):
    """The plain version: ``F.elu(F.group_norm(x))`` (NCHW out)."""
    return F.elu(F.group_norm(x.contiguous(), GROUPS, weight, bias, eps))


def _per_channel(t, channels):
    """[B,16] -> [B,C,1,1], each group's value on its channels."""
    return t.repeat_interleave(channels // GROUPS, 1)[:, :, None, None]


def plain_forward(x, weight, bias, eps=1e-5):
    """The kernels' forward in plain PyTorch -> (y, mean, rstd): fp32
    statistics over each (image, group), ``a = rstd * gamma``, ``b = beta -
    a * mean``, ``y = elu(x * a + b)`` rounded once to ``x``'s dtype, in
    ``x``'s layout; mean and rstd [B,16] fp32."""
    b, c = x.shape[:2]
    xf = x.float()
    xg = xf.reshape(b, GROUPS, -1)
    mean = xg.mean(-1)
    rstd = torch.rsqrt(xg.var(-1, unbiased=False) + eps)
    a = _per_channel(rstd, c) * weight.float()[:, None, None]
    shift = bias.float()[:, None, None] - a * _per_channel(mean, c)
    return F.elu(xf * a + shift).to(x.dtype), mean, rstd


def plain_backward(grad, x, y, mean, rstd, weight):
    """The kernels' backward in plain PyTorch -> (dx, dweight, dbias): the
    ELU's derivative from ``y``, ATen's GroupNorm backward from the sums
    ``ds = sum dz * x`` and ``db = sum dz`` of each (image, channel), in fp32,
    each result rounded once."""
    b, c = x.shape[:2]
    cg = c // GROUPS
    n = cg * x.shape[2] * x.shape[3]
    xf, yf, gf = x.float(), y.float(), grad.float()
    dz = torch.where(yf > 0, gf, gf * (yf + 1))
    ds, db = (dz * xf).sum((2, 3)), dz.sum((2, 3))            # [B,C]
    gamma = weight.float()
    sum1 = (ds * gamma).reshape(b, GROUPS, cg).sum(-1)
    sum2 = (db * gamma).reshape(b, GROUPS, cg).sum(-1)
    c2 = (sum2 * mean - sum1) * rstd ** 3 / n
    c3 = -c2 * mean - sum2 * rstd / n
    dx = (_per_channel(rstd, c) * gamma[:, None, None] * dz
          + _per_channel(c2, c) * xf + _per_channel(c3, c))
    mean_c, rstd_c = _per_channel(mean, c)[..., 0, 0], _per_channel(rstd, c)[..., 0, 0]
    dweight = ((ds - db * mean_c) * rstd_c).sum(0)
    return dx.to(x.dtype), dweight.to(weight.dtype), db.sum(0).to(weight.dtype)


def _check(x, *params):
    """Raise unless the kernels take ``x`` [B,C,H,W] and ``params`` [C]."""
    if x.device.type != 'cuda':
        raise ValueError(f'gn_elu kernel takes a CUDA tensor, got {x.device}')
    if x.ndim != 4:
        raise ValueError(f'expected [B,C,H,W], got {tuple(x.shape)}')
    b, c = x.shape[:2]
    if not supported(c) or not 0 < b <= _MAX_BATCH or x.shape[2] * x.shape[3] == 0:
        raise ValueError(f'gn_elu kernel takes C a multiple of 16 up to {_MAX_CHANNELS} with '
                         f'C/16 in (1, 2, 4) or a multiple of 8, 1 <= B <= {_MAX_BATCH} and '
                         f'H, W >= 1, got {tuple(x.shape)}')
    if any(t.dtype != torch.bfloat16 for t in (x, *params)):
        raise TypeError(f'gn_elu kernel takes bfloat16, got {[t.dtype for t in (x, *params)]}')
    if any(tuple(p.shape) != (c,) or p.device != x.device or not p.is_contiguous()
           for p in params):
        raise ValueError(f'gn_elu kernel takes contiguous weight and bias [{c}] on {x.device}')


def _nhwc(t):
    """``t`` channels-last and 16-byte aligned: a copy where it is not."""
    t = t.contiguous(memory_format=torch.channels_last)
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.channels_last)
    return t


def _raise(err, what):
    if err:
        raise RuntimeError(f'gn_elu_kernel {what} failed: {_kernel()[2](err).decode()} ({err})')


def launch(x, weight, bias, eps=1e-5):
    """The forward kernels: channels-last bf16 CUDA ``x`` [B,C,H,W] with
    ``weight`` and ``bias`` [C] -> (y channels-last, mean [B,16], rstd
    [B,16] fp32)."""
    global launches
    _check(x, weight, bias)
    x = _nhwc(x)
    b, c, h, w = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(b, GROUPS, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    forward = _kernel()[0]
    with torch.cuda.device(x.device):
        n = _tiles(b, h * w, c, _sms(x.device.index))
        partial = torch.empty(b, n, GROUPS, 3, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = forward(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                      mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
                      b, h * w, c, n, float(eps), stream)
    _raise(err, 'launch')
    launches += 1
    count('gn_elu_kernel', 1)
    return y, mean, rstd


def launch_backward(grad, x, y, mean, rstd, weight):
    """The backward kernels: the output's gradient and what the forward
    saved -> (dx channels-last, dweight, dbias), bf16."""
    _check(x, weight)
    if tuple(grad.shape) != tuple(x.shape) or grad.dtype != x.dtype or grad.device != x.device:
        raise ValueError(f'expected a bfloat16 gradient {tuple(x.shape)} on {x.device}, '
                         f'got {grad.dtype} {tuple(grad.shape)} on {grad.device}')
    grad, x, y = _nhwc(grad), _nhwc(x), _nhwc(y)
    b, c, h, w = x.shape
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    backward = _kernel()[1]
    with torch.cuda.device(x.device):
        n = _tiles(b, h * w, c, _sms(x.device.index))
        partial = torch.empty(b, n, c, 2, dtype=torch.float32, device=x.device)
        coef = torch.empty(b, GROUPS, 2, dtype=torch.float32, device=x.device)
        affine = torch.empty(b, c, 2, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = backward(grad.data_ptr(), y.data_ptr(), x.data_ptr(), weight.data_ptr(),
                       mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dweight.data_ptr(),
                       dbias.data_ptr(), partial.data_ptr(), coef.data_ptr(), affine.data_ptr(),
                       b, h * w, c, n, stream)
    _raise(err, 'backward launch')
    return dx, dweight, dbias


class GroupNormEluFn(torch.autograd.Function):
    """:func:`launch` forward, :func:`launch_backward` backward:
    ``apply(x, weight, bias, eps)`` -> ``elu(group_norm(x, 16, weight, bias,
    eps))``, channels-last."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = launch(x, weight, bias, eps)
        ctx.save_for_backward(x, mean, rstd, y, weight)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, mean, rstd, y, weight = ctx.saved_tensors
        dx, dweight, dbias = launch_backward(grad, x, y, mean, rstd, weight)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dweight if need[1] else None,
                dbias if need[2] else None, None)
