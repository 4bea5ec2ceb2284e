"""The precisions of the reference and of its control.

The reference computes in fp32 with TF32 off.  Its control computes in
the nearest precision below the one a configuration states: TF32 for an
fp32 configuration (``tf32``), and fp8 (e4m3, one scale per tensor, as an
fp8 inference or training recipe runs a conv) for a bf16 one
(``fp8_e4m3``), applied to every convolution's input and weight.
"""

import contextlib

import torch

FP8_MAX = 448.0         # largest finite float8_e4m3fn


def fp8_e4m3(t):
    """``t`` rounded to fp8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, in ``t``'s dtype; gradients pass straight
    through the rounding."""
    scale = torch.clamp(t.detach().abs().amax().float(), min=1e-30) / FP8_MAX
    q = (t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


@contextlib.contextmanager
def tf32(enabled):
    """TF32 in cuDNN convs and CUDA matmuls on (``enabled``) or off, restored
    on exit."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def control(precision):
    """(quant, tf32 on) of the control of a configuration that states
    ``precision``."""
    if precision == 'float32':
        return None, True
    if precision == 'bfloat16':
        return fp8_e4m3, False
    raise ValueError(f'no control for precision {precision!r}')
