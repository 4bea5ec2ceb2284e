"""Device ms per request of the network's 1-channel 3-D pack and unpack
convs: the program's spans ``mte.net.conv3d``, summed over the request."""

from portbench.program_spans import span_ms


def read(ctx):
    return span_ms(ctx, 'infer', 'mte.net.conv3d', 'device_ms')
