"""The device's idle share of the profiled window, training."""

from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, 'train')
