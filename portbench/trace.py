"""Spans and the profiler's trace, reduced to what the per-layer
readers read.

* :class:`Spans`: CUDA events recorded from the benchmark's own files,
  around each timed unit (a request, a batch or a step) and at the hooks
  that an entry registers on the program's layers (the network's forward
  pre- and post-hooks, the optimizer's step hooks).  Reduced after the
  window to device milliseconds per unit.
* :func:`union_seconds`, :func:`gaps`: the
  device's busy time as the union of its kernel, copy and set intervals
  (overlapping kernels count once), and the idle gaps between them.
* :func:`profile_summary`: the busy and window seconds, the NMS kernel's
  durations, and the ``breakdown`` of the result line.
"""

import time

import torch

NMS_KERNEL = 'nms'       # the Sobel-5 + NMS kernel's name contains this


class HostEvent:
    """A host-clock stand-in for a CUDA event, so that the CPU tests drive
    the same reduction; no run on the card uses it."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class Spans:
    """Device time of named spans, per timed unit, by CUDA events."""

    def __init__(self, enabled, device):
        self.enabled = enabled
        self.cuda = torch.device(device).type == 'cuda'
        self.units = []
        self.cur = None

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else HostEvent()
        ev.record()
        return ev

    def begin(self):
        if self.enabled:
            self.cur = {'start': self._event(), 'marks': []}

    def mark(self, name):
        """An edge of span ``name``: its begin and end alternate."""
        if self.enabled and self.cur is not None:
            self.cur['marks'].append((name, self._event()))

    def end(self):
        if self.enabled and self.cur is not None:
            self.cur['end'] = self._event()
            self.units.append(self.cur)
            self.cur = None

    def hook_module(self, module, name):
        """Mark ``name`` at ``module``'s forward pre- and post-hooks."""
        return [module.register_forward_pre_hook(lambda *a: self.mark(name)),
                module.register_forward_hook(lambda *a: self.mark(name))]

    def reduce(self):
        """[{'unit': ms, span: summed ms, span + '.last_end_to_unit_end': ms}]
        per unit, after a synchronize."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for u in self.units:
            row = {'unit': u['start'].elapsed_time(u['end'])}
            opened = {}
            for name, ev in u['marks']:
                if name in opened:
                    row[name] = row.get(name, 0.0) + opened.pop(name).elapsed_time(ev)
                    row[name + '.last_end_to_unit_end'] = ev.elapsed_time(u['end'])
                else:
                    opened[name] = ev
            out.append(row)
        return out


def _device_events(prof):
    """[(name, start, end)] ns of the kernels, copies and sets: the device
    events but the ``record_function`` ranges, which the trace also shows on
    the device's timeline under their host names (no kernel is named as a
    host op is)."""
    events = prof.profiler.kineto_results.events()
    annotations = {e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CPU}
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0
            and e.name() not in annotations and not e.name().startswith('portbench.')]


def _host_events(prof):
    """[(name, start, end)] ns of the host's ops and ranges, the profiler's
    own buffer requests left out."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU and e.duration_ns() > 0
            and not e.name().startswith('Activity Buffer')]


def union_seconds(intervals):
    """Seconds covered by the union of [start, end] ns intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals, lo, hi):
    """[(start, end)] ns of the idle gaps within [lo, hi] between the union
    of ``intervals``."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def host_op_at(host, t):
    """The innermost host op running at ns ``t``, or 'no host op'."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else 'no host op'


def profile_summary(prof, lo_ns, hi_ns, top=10):
    """The profiled window [lo_ns, hi_ns]: busy and window seconds, the NMS
    kernel's durations (s) and the breakdown: the ``top`` device ops by
    total seconds and the ``top`` longest idle gaps by the host op
    running at their middle."""
    dev = [(n, max(s, lo_ns), min(e, hi_ns)) for n, s, e in _device_events(prof)
           if e > lo_ns and s < hi_ns]
    intervals = [(s, e) for _, s, e in dev]
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    host = _host_events(prof)
    idle = sorted(gaps(intervals, lo_ns, hi_ns), key=lambda g: g[0] - g[1])[:top]
    return {
        'busy_s': union_seconds(intervals),
        'window_s': (hi_ns - lo_ns) / 1e9,
        'nms_s': [(e - s) / 1e9 for n, s, e in dev if NMS_KERNEL in n.lower()],
        'breakdown': {
            'device_ops': sorted(([n, v] for n, v in by_name.items()), key=lambda x: -x[1])[:top],
            'idle_gaps': [[host_op_at(host, (s + e) // 2), (e - s) / 1e9] for s, e in idle]},
    }
