"""Step timing: counterpart of ``mindtheedge_tpu/utils/profiling.StepTimer``.

``StepTimer`` times a block on the host clock, skipping ``warmup`` blocks.
A training step enqueues its work on the card and returns, so a single
step's host time is its enqueue time; over many steps the queue fills and
the mean approaches the device time.  Device times come from CUDA events
(``chip_smoke.py``).
"""

import time

import numpy as np


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
