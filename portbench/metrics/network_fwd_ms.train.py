"""Device ms per step of the depth network's forward calls, both passes."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'network_fwd')
