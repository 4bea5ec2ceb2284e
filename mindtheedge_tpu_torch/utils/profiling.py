"""Timing and tracing hooks: counterpart of
``mindtheedge_tpu/utils/profiling.py``.

* ``StepTimer`` times a block on the host clock, skipping ``warmup``
  blocks.  A training step enqueues its work on the card and returns, so a
  single step's host time is its enqueue time; over many steps the queue
  fills and the mean approaches the device time.  Device times come from
  CUDA events (``chip_smoke.py``).
* ``trace`` records a block with ``torch.profiler`` (the host, and the
  card where there is one) into a Chrome trace; it degrades to running the
  block untraced where the profiler cannot start.
* ``device_memory_stats`` gives the caching allocator's statistics of each
  visible CUDA device.
"""

import contextlib
import os
import time

import numpy as np
import torch


class StepTimer:
    def __init__(self, warmup=2):
        self.warmup = warmup
        self.times = []
        self._t0 = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self):
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            'steps': len(arr),
            'mean_s': float(arr.mean()),
            'p50_s': float(np.percentile(arr, 50)),
            'p95_s': float(np.percentile(arr, 95)),
            'max_s': float(arr.max()),
        }


@contextlib.contextmanager
def trace(log_dir='/tmp/mte_trace', enabled=True):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``log_dir`` (``profiling.py:48-69``);
    where the profiler cannot start or write, it prints why and the block
    runs all the same."""
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
