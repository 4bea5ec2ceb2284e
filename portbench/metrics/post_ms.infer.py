"""Device ms per request of the program's span ``mte.serve.post``: the
maps from the inverse depth, the NMS kernel and the wire encodes."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'infer', 'mte.serve.post', 'device_ms')
