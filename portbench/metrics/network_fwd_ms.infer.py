"""Device ms per request of the depth network's forward calls."""

from portbench.readers import span_ms


def read(ctx):
    return span_ms(ctx, 'infer', 'network_fwd')
