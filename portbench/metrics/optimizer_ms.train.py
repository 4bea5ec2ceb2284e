"""Device ms per step of the optimizer's step, between its step hooks."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'optimizer')
