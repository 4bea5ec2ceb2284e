"""The benchmark of ``mindtheedge_tpu_torch`` on one NVIDIA H100: one run
of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's files are found by name from
``BENCHMARK.json``: its configuration's file, its traffic mix
``portbench/workloads/<traffic>.json``, the entry the mix names
``portbench/entries/<entry>.py``, and a reader ``portbench/metrics/<metric>.py``
for each metric the cell reports.  The run sets up (weights and inputs
from the seed, the program built, its kernels loaded, the cell's own
shapes warmed up), measures for ``--seconds``, and with ``--trace 1``
records spans from hooks and then profiles a short second window.  Once
the window has closed and the peak memory has been read, it frees the
program, runs the plain reference (``portbench/reference``) on a sample
drawn from the seed, and prints each number compared beside its limit on
standard error and, as the last line of standard output, one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# kernel and build caches of the program inside the checkout, at fixed paths
_BUILD = Path(__file__).resolve().parents[1] / 'build'
os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(_BUILD / 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', str(_BUILD / 'triton'))

import torch  # noqa: E402

from portbench import flops  # noqa: E402
from portbench.common import HERE, cell_files, load_module, metrics_of  # noqa: E402
from portbench.trace import Spans, profile_summary  # noqa: E402
from portbench.traffic import stream_seed  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mindtheedge_tpu', 'tests')
PROFILE_S = 2.0          # the profiled second window of a traced run
PROFILE_MIN_UNITS = 3


def forbidden_modules():
    """Top-level names in ``sys.modules`` that a run may not load, compared
    whole (``mindtheedge_tpu_torch`` is the program, not the JAX package)."""
    return sorted({name.split('.')[0] for name in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of ``k`` of the answered units, drawn from the seed."""

    def __init__(self, k, seed):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def window(cell, seconds, spans, device, sample):
    """Closed loop, one client: units back to back for ``seconds``.  An
    inference unit ends with its results on the host; the training window
    ends in a synchronize.  -> (units, window seconds, unit latencies)."""
    cuda = torch.device(device).type == 'cuda'
    latencies, n = [], 0
    t0 = time.perf_counter()
    t_last = t0
    while n == 0 or time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        spans.begin()
        out = cell.unit(n)
        spans.end()
        t_last = time.perf_counter()
        latencies.append(t_last - ts)
        if out is not None:
            sample.offer(out)
        n += 1
    if cuda:
        torch.cuda.synchronize()
    if cell.kind == 'train':
        t_last = time.perf_counter()
    return n, t_last - t0, latencies


def profiled(cell, device, start):
    """A second window under ``torch.profiler``: at least
    ``PROFILE_MIN_UNITS`` units and ``PROFILE_S`` seconds -> (summary, units)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function('portbench.client'):
            n, t0 = 0, time.perf_counter()
            while n < PROFILE_MIN_UNITS or time.perf_counter() - t0 < PROFILE_S:
                with record_function('portbench.unit'):
                    cell.unit(start + n)
                n += 1
            if torch.device(device).type == 'cuda':
                torch.cuda.synchronize()
    mark = next(e for e in prof.profiler.kineto_results.events()
                if e.name() == 'portbench.client' and not _is_device(e))
    return profile_summary(prof, mark.start_ns(), mark.start_ns() + mark.duration_ns()), n


def _is_device(e):
    return e.device_type() == torch.autograd.DeviceType.CUDA


def read_metrics(entries, ctx):
    out = {}
    for m in entries:
        reader = load_module(HERE / 'metrics' / f'{m["name"]}.py')
        value = reader.read(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def run_cell(name, seed, seconds, trace, device='cuda', program='port', adjust=None):
    """One run of cell ``name`` -> the result object.  ``adjust(config,
    traffic)`` may change the cell's files in memory (the CPU tests shrink
    the shapes with it)."""
    cell_entry, config, traffic = cell_files(name)
    if traffic['loop'] != {'kind': 'closed', 'clients': 1}:
        raise ValueError(f'{name}: the harness drives one closed-loop client, not {traffic["loop"]}')
    if adjust is not None:
        adjust(config, traffic)
    entry = load_module(HERE / 'entries' / f'{traffic["entry"]}.py')
    cuda = torch.device(device).type == 'cuda'
    t_cell = time.perf_counter()
    cell = entry.Cell(config, traffic, seed, device, program)
    t_built = time.perf_counter()
    spans = Spans(bool(trace), device)
    if trace:
        cell.attach(spans)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    sample = Reservoir(cell.sample_size, stream_seed(seed, 'sample'))
    units, window_s, latencies = window(cell, seconds, spans, device, sample)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {'kind': cell.kind, 'precision': cell.precision, 'units': units,
           'window_s': window_s, 'latencies_s': latencies, 'setup_s': setup_s,
           'images_per_unit': cell.images_per_unit, 'window_peak_bytes': window_peak}
    result_device = {'platform': 'gpu' if cuda else 'cpu',
                     'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
                     'count': 1}
    if trace:
        ctx['spans'] = spans.reduce()
        summary, prof_units = profiled(cell, device, units)
        launches, bound_s = cell.nms_per_unit()
        ctx.update(profile=summary, profiled_units=prof_units, nms_launches_per_unit=launches,
                   nms_bound_s_per_unit=bound_s, flops_per_unit=cell.flops_per_unit(),
                   peak_flops=flops.PEAK_FLOPS[cell.precision])
        result_device.update(busy_s=summary['busy_s'], window_s=summary['window_s'])
        metrics = read_metrics(metrics_of(name, 'per_layer'), ctx)
    else:
        metrics = read_metrics(metrics_of(name, 'end_to_end'), ctx)
    result_device['memory_peak_bytes'] = (max(setup_peak, torch.cuda.max_memory_allocated())
                                          if cuda else 0)
    t_check = time.perf_counter()
    numbers = cell.check(sample.items)
    print(f'portbench: {name} seed {seed}: setup {setup_s:.3f} s, window {window_s:.3f} s '
          f'({units} units), check {time.perf_counter() - t_check:.3f} s', file=sys.stderr)
    print(f'portbench: setup: imports {t_cell - T_START:.3f} s, cell {t_built - t_cell:.3f} s '
          f'(of which warm-up {cell.warmup_s:.3f} s)', file=sys.stderr)
    for k, v in numbers.items():
        if k not in cell.limits:
            print(f'reading {k} {v!r} (not compared)', file=sys.stderr)
    checks = {k: {'value': numbers[k], 'limit': limit} for k, limit in cell.limits.items()}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit'] for c in checks.values())
    result = {'correct': correct, 'attempted': units, 'failed': 0, 'metrics': metrics,
              'device': result_device}
    if trace:
        result['breakdown'] = ctx['profile']['breakdown']
    result['readings'] = {k: v for k, v in numbers.items() if k not in cell.limits}
    result['checks'] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell_entry, _, _ = cell_files(args.workload)
    chips = cell_entry['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA device(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} available',
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f'portbench: the run loaded {", ".join(found)}', file=sys.stderr)
        return 3
    for k, c in result['checks'].items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
