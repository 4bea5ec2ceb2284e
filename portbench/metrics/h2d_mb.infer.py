"""MB (1e6 bytes) per request that ``serve.serve`` copies from the host to
the card: the program's counter ``h2d_bytes``."""

from portbench.program_spans import counter


def read(ctx):
    value = counter(ctx, 'infer', 'h2d_bytes')
    return None if value is None else value / 1e6
