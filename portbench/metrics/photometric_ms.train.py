"""Device ms per step of the program's span ``mte.train.photometric``: the
multi-view photometric loss (warps, SSIM, the minimum, smoothness) in the
forward."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'mte.train.photometric', 'device_ms')
