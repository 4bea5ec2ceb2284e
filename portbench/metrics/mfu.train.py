"""The whole step's share of the precision's peak FLOP rate."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, 'train')
