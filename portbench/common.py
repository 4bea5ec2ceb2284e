"""What the entries share: the files of a cell found by name, the task
configuration, the weights, and the comparisons' arithmetic."""

import importlib.util
import json
import math
import statistics
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A Python file of the benchmark, by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f'portbench_file_{Path(path).stem}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark():
    return load_json(ROOT / 'BENCHMARK.json')


def cell_files(name):
    """(workload entry, configuration, traffic mix) of the cell ``name``."""
    bench = benchmark()
    cell = next((c for c in bench['workloads'] if c['name'] == name), None)
    if cell is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == cell['config'])
    config = load_json(ROOT / conf['file'])
    traffic = load_json(HERE / 'workloads' / f'{cell["traffic"]}.json')
    return cell, config, traffic


def metrics_of(cell_name, kind):
    """The cell's end-to-end metrics (``kind`` 'end_to_end') or per-layer
    metrics ('per_layer'): the entries whose ``workloads`` name it, or
    that have no ``workloads`` and move a metric the cell reports."""
    bench = benchmark()
    e2e = [m for m in bench['end_to_end'] if cell_name in m.get('workloads', [cell_name])]
    if kind == 'end_to_end':
        return e2e
    names = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if cell_name in m['workloads'] or ('workloads' not in m and m['moves'] in names)]


def task_config(overrides):
    """The program's configuration tree: its defaults, then ``overrides``
    (a yaml's content, as a dict)."""
    from mindtheedge_tpu_torch.config import get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(overrides)
    return cfg


def synchronize(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def release(device):
    """Free what the program held, once its objects are dropped."""
    import gc
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def norm(t):
    return float(torch.linalg.vector_norm(t.detach().double()))


def relative_gap(got, want):
    return abs(got - want) / abs(want) if want else abs(got)


def leaf_gaps(prog, ref, leaves=None):
    """{leaf: the gap between the program's and the reference's norm of the
    leaf, over the larger of the reference's norm of that leaf and of the
    median leaf}."""
    leaves = list(ref) if leaves is None else list(leaves)
    if not leaves:
        return {}
    med = statistics.median(ref[k] for k in leaves)
    gaps = {}
    for k in leaves:
        base = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / base if base > 0 else abs(prog[k] - ref[k])
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst_leaf(prog, ref, leaves=None):
    """(gap, leaf) of the leaf with the largest of :func:`leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, leaves)
    if not gaps:
        return 0.0, None
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf

