"""What the readers of the program's own spans and counter share: the
requests and steps that ``mindtheedge_tpu_torch.utils.profiling`` recorded
in the profiled window of a ``--trace 1`` run (the program's tracing is on
while a profiler records, and only then).  Each reader returns None where
the run is of another kind, or where the program keeps no such record (a
program older than its spans has no ``profiling.records``)."""

ROOTS = {'infer': 'mte.serve.request', 'train': 'mte.train.step'}


def units(ctx, kind):
    """The profiled window's records of the cell's units (requests or
    steps), read once a run; None where there are none."""
    if ctx['kind'] != kind or 'profile' not in ctx:
        return None
    if 'program_records' not in ctx:
        from mindtheedge_tpu_torch.utils import profiling
        read = getattr(profiling, 'records', None)
        ctx['program_records'] = read() if read is not None else []
    rows = [r for r in ctx['program_records'] if r['name'] == ROOTS[kind]]
    return rows or None


def span_ms(ctx, kind, name, field):
    """The mean over the units of the summed ``field`` (``host_ms``,
    ``device_ms``, ``self_device_ms``, ...) of the unit's spans ``name``."""
    rows = units(ctx, kind)
    if rows is None or not any(s['name'] == name for r in rows for s in r['spans']):
        return None
    return sum(sum(s[field] for s in r['spans'] if s['name'] == name) for r in rows) / len(rows)


def counter(ctx, kind, name):
    """The mean over the units of counter ``name``."""
    rows = units(ctx, kind)
    if rows is None or not any(name in r['counters'] for r in rows):
        return None
    return sum(r['counters'].get(name, 0) for r in rows) / len(rows)
