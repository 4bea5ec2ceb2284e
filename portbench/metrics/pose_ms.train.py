"""Device ms per step of the program's span ``mte.net.pose``: the pose
network's forward and the pose vectors' transforms."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'train', 'mte.net.pose', 'device_ms')
