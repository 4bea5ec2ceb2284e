"""Device ms per step of the program's spans ``mte.train.warp``, summed:
the forward of every view synthesis (reconstruct, project, grid_sample),
one a scale and context."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'mte.train.warp', 'device_ms')
