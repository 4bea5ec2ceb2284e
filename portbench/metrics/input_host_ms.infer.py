"""Host ms per request of the program's span ``mte.serve.input``: the
upload and normalisation of the RGB, the LiDAR's cast and upload."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'infer', 'mte.serve.input', 'host_ms')
