"""Tracing of the port: spans and counters inside the program, a Chrome
trace of a block, and the device's memory statistics.

* ``span(name)`` marks a range of the program's work.  ``count(name, n)``
  adds ``n`` to a counter of the request that is open.  ``records()``
  reads them back per request; ``reset()`` empties the buffer.
* Tracing is on while a ``torch.profiler`` (or any autograd profiler)
  records, and inside ``with recording():``; else a span is one shared
  no-op object and a count returns at once.  On, a span enters
  ``torch.profiler.record_function(name)``, so that it sits in the
  profiler's trace on the kernels' clock (on the card with its device-side
  ``gpu_user_annotation``), and keeps a record: its name, its parent span,
  its request, its host start and end (``time.perf_counter_ns``) and an
  event at each edge, a CUDA event once CUDA is initialised, else the host
  clock's.
* A span opened with no span open (``mte.serve.request``,
  ``mte.train.step``) opens a request, whose id is its own; the spans and
  counts opened inside it share that id.
* The buffer keeps the newest :data:`BUFFER` records (spans and counts);
  ``records()`` leaves out a request whose first span has gone from it.
* ``trace(log_dir)`` records a block with ``torch.profiler`` into a
  Chrome trace, which then holds the spans; it degrades to running the
  block untraced where the profiler cannot start.
* ``device_memory_stats`` gives the caching allocator's statistics of each
  visible CUDA device.

The program's spans and counter, and the benchmark's metrics that read
them (``portbench/metrics/``):

* ``mte.serve.request`` (``serve.serve``): a request's root;
  ``mte.serve.input``: its uploads and casts (``input_host_ms.infer``),
  with the counter ``h2d_bytes``, the bytes copied from the host to the
  card (``h2d_mb.infer``); ``mte.serve.post``: the maps, the NMS kernel
  and the wire encodes (``post_ms.infer``);
* ``mte.net.forward`` (``models.packnet.PackNetSAN.forward`` and
  ``PackNet01.forward``) and, inside it, ``mte.net.conv3d``
  (``ops.blocks.Conv3dOverChannels``, 10 a pass: ``conv3d_ms.infer``);
* ``mte.train.step`` (``training.train_step``): a step's root, around
  ``mte.train.zero_grad``, ``mte.train.loss`` (``loss_ms.train``, less the
  networks and the photometric loss), ``mte.train.backward``
  (``backward_ms.train``), ``mte.train.grad_norm`` and
  ``mte.train.optimizer``;
* inside ``mte.train.loss`` of the self-supervised tasks: ``mte.net.pose``
  (``models.tasks.BaseTask.run_pose``: ``pose_ms.train``) and
  ``mte.train.photometric`` (the call of
  ``losses.photometric.multiview_photometric_loss``:
  ``photometric_ms.train``), and inside that ``mte.train.warp``
  (``geometry.camera.view_synthesis``, one a scale and context:
  ``warp_ms.train``), with the counter ``view_synthesis``, 1 a call, and
  on the card the counter ``warp_kernel``, 1 a launch of the warp's
  geometry kernel (``ops.cuda.warp_kernel.launch``; no metric reads it).
"""

import collections
import contextlib
import itertools
import os
import time

import torch

BUFFER = 1 << 16        # records kept (spans and counts), the newest

_profiler_on = torch._C._autograd._profiler_enabled
_recording = 0
_buffer = collections.deque(maxlen=BUFFER)
_open = []              # the open spans, innermost last
_ids = itertools.count()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _HostEvent:
    """The host clock in a CUDA event's place."""

    __slots__ = ('t',)

    def record(self):
        self.t = time.perf_counter_ns()

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def _event():
    ev = (torch.cuda.Event(enable_timing=True) if torch.cuda.is_initialized()
          else _HostEvent())
    ev.record()
    return ev


class _Span:
    __slots__ = ('name', 'id', 'parent', 'request', 'start_ns', 'end_ns',
                 'start_ev', 'end_ev', '_range')

    def __init__(self, name):
        self.name = name
        self.end_ev = None

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        self.start_ev = _event()
        _buffer.append(self)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ev = _event()
        self.end_ns = time.perf_counter_ns()
        _open.pop()
        self._range.__exit__(*exc)
        self._range = None
        return False


def span(name):
    """A context manager marking the block as span ``name`` (see the
    module's docstring); a shared no-op where tracing is off."""
    if not (_recording or _profiler_on()):
        return _NOOP
    return _Span(name)


def count(name, n):
    """Add ``n`` to counter ``name`` of the open request, where tracing is
    on and a request is open."""
    if _open and (_recording or _profiler_on()):
        _buffer.append((name, _open[-1].request, n))


@contextlib.contextmanager
def recording():
    """Tracing on inside the block, without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def reset():
    """Empty the buffer of records."""
    _buffer.clear()


def _union(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def self_times(spans, clock):
    """{span id: its ``clock`` ('host' or 'device') ms less the union of its
    children's intervals within it}, for spans given as dicts with ``id``,
    ``parent`` and ``<clock>_start`` / ``<clock>_end`` in ms."""
    children = collections.defaultdict(list)
    for s in spans:
        children[s['parent']].append(s)
    out = {}
    for s in spans:
        lo, hi = s[f'{clock}_start'], s[f'{clock}_end']
        covered = _union([(max(c[f'{clock}_start'], lo), min(c[f'{clock}_end'], hi))
                          for c in children[s['id']] if c[f'{clock}_end'] > lo
                          and c[f'{clock}_start'] < hi])
        out[s['id']] = (hi - lo) - covered
    return out


def records():
    """The finished requests in the buffer, oldest first, after one
    synchronize: ``[{'request': id, 'name': the root span's name, 'spans':
    [...], 'counters': {name: total}}]``.  Each span is a dict of ``id``,
    ``name``, ``parent`` (an id, None for the root), ``host_start_ns`` and
    ``host_end_ns``, ``host_ms`` and ``device_ms``, their starts and ends
    in ms from the root's start (``host_start``, ``device_start``, ...)
    and ``self_host_ms`` / ``self_device_ms``: the span less what its
    children cover.  Spans still open are left out."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    items = list(_buffer)
    roots = {r.id: r for r in items
             if isinstance(r, _Span) and r.parent is None and r.end_ev is not None}
    requests = {rid: {'request': rid, 'name': root.name, 'spans': [], 'counters': {}}
                for rid, root in roots.items()}
    for r in items:
        if isinstance(r, tuple):
            name, rid, n = r
            if rid in requests:
                counters = requests[rid]['counters']
                counters[name] = counters.get(name, 0) + n
        elif r.request in requests and r.end_ev is not None:
            root = roots[r.request]
            requests[r.request]['spans'].append({
                'id': r.id, 'name': r.name, 'parent': r.parent,
                'host_start_ns': r.start_ns, 'host_end_ns': r.end_ns,
                'host_start': (r.start_ns - root.start_ns) / 1e6,
                'host_end': (r.end_ns - root.start_ns) / 1e6,
                'device_start': root.start_ev.elapsed_time(r.start_ev),
                'device_end': root.start_ev.elapsed_time(r.end_ev)})
    for req in requests.values():
        spans = req['spans']
        for clock in ('host', 'device'):
            selfs = self_times(spans, clock)
            for s in spans:
                s[f'{clock}_ms'] = s[f'{clock}_end'] - s[f'{clock}_start']
                s[f'self_{clock}_ms'] = selfs[s['id']]
    return [requests[rid] for rid in sorted(requests)]


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir`` (``profiling.py:48-69``),
    with the program's spans in it; where the profiler cannot start or
    write, it prints why and the block runs all the same."""
    if not enabled:
        yield
        return
    prof = None
    try:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        prof = None
        print(f'profiler trace unavailable: {type(e).__name__}: {e}')
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json')
                prof.export_chrome_trace(path)
                print(f'profiler trace written to {path}')
            except Exception as e:
                print(f'profiler trace unavailable: {type(e).__name__}: {e}')


def device_memory_stats():
    """``torch.cuda.memory_stats`` of each visible CUDA device, keyed by
    the device (``cuda:0``, ...); ``{}`` without one (``profiling.py:72-81``)."""
    if not torch.cuda.is_available():
        return {}
    return {f'cuda:{i}': torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
