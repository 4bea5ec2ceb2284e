"""What the per-layer readers of ``portbench/metrics/`` share.  Each
returns None where the run has nothing of the kind ``kind`` ('infer' or
'train') to read, and the harness then leaves the metric out."""


def span_ms(ctx, kind, key):
    """The mean over the traced window's units of span ``key``'s device
    milliseconds (CUDA events at the hooks an entry registers)."""
    if ctx['kind'] != kind:
        return None
    rows = [r[key] for r in ctx.get('spans', []) if key in r]
    return sum(rows) / len(rows) if rows else None


def idle_pct(ctx, kind):
    """The share of the profiled window in which no kernel, copy or set runs
    on the device: one minus the union of the device's intervals over the
    window (torch.profiler's trace), in %."""
    if ctx['kind'] != kind or 'profile' not in ctx or not ctx['profile']['busy_s']:
        return None
    p = ctx['profile']
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])


def mfu_pct(ctx, kind):
    """The model FLOP of the window's units (``portbench/flops.py``, counted
    from the configuration's shapes and the LiDAR's active sites) over the
    window's seconds and the peak of the cell's precision, in %."""
    if ctx['kind'] != kind or 'flops_per_unit' not in ctx:
        return None
    rate = ctx['flops_per_unit'] * ctx['units'] / ctx['window_s']
    return 100.0 * rate / ctx['peak_flops']
