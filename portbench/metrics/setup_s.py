"""Seconds from process start to the first timed unit: imports, weights
and inputs made from the seed, the program built with its kernels, the
cell's shapes warmed up (host clock)."""


def read(ctx):
    return ctx['setup_s']
