"""The NMS kernel's share of its roofline: the sum of its launches' bounds
(portbench/flops.nms_bound_s: the input read once and the output written
once at the HBM rate, or the operations at the fp32 peak, whichever is
longer) over the sum of its kernel durations in the profiled window, in %.
Nothing where the profiled window's NMS kernels are not the units' own."""


def read(ctx):
    if ctx['kind'] != 'infer' or 'profile' not in ctx:
        return None
    durations = ctx['profile']['nms_s']
    launches = ctx['nms_launches_per_unit'] * ctx['profiled_units']
    if not durations or len(durations) != launches:
        return None
    return 100.0 * ctx['nms_bound_s_per_unit'] * ctx['profiled_units'] / sum(durations)
