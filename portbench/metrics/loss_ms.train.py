"""Device ms per step of the program's span ``mte.train.loss`` less the
network's forward inside it (its self time): the task's casts, flips,
upsampling and losses."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'mte.train.loss', 'self_device_ms')
