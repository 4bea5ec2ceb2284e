"""Device ms per step of the program's span ``mte.train.backward``."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'mte.train.backward', 'device_ms')
