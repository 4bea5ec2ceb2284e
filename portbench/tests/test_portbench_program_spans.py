"""The readers of the program's own spans and counter
(``portbench/program_spans.py``): in a CPU dry run with ``--trace 1`` each
of the six reads a finite value in its cells; each reads None in a cell of
the other kind, in a run without a profiled window, and where the program
keeps no records (a program older than its spans)."""

import json
import math

import pytest

from portbench.common import HERE, benchmark, load_module

READERS = ['input_host_ms.infer', 'h2d_mb.infer', 'conv3d_ms.infer', 'post_ms.infer',
           'loss_ms.train', 'backward_ms.train']
CELLS = [c['name'] for c in benchmark()['workloads']]


def cells_of(metric):
    return next(m['workloads'] for m in benchmark()['per_layer'] if m['name'] == metric)


def reader(metric):
    return load_module(HERE / 'metrics' / f'{metric}.py')


@pytest.mark.parametrize('cell', CELLS)
def test_dry_run_reads_each_in_its_cells(cell):
    from portbench.tests.tiny import dry_run
    line = json.loads(dry_run(cell, 2 ** 31 + 5, 1))
    for metric in READERS:
        if cell in cells_of(metric):
            value = line['metrics'][metric]['value']
            assert math.isfinite(value) and value >= 0, (metric, value)
        else:
            assert metric not in line['metrics']


@pytest.mark.parametrize('metric', READERS)
def test_none_elsewhere(metric, monkeypatch):
    kind = metric.rsplit('.', 1)[1]
    other = 'train' if kind == 'infer' else 'infer'
    request = {'request': 0, 'name': 'mte.serve.request', 'counters': {'h2d_bytes': 8},
               'spans': [{'name': n, 'host_ms': 1.0, 'device_ms': 1.0, 'self_device_ms': 1.0}
                         for n in ('mte.serve.input', 'mte.net.conv3d', 'mte.serve.post')]}
    step = {'request': 1, 'name': 'mte.train.step', 'counters': {},
            'spans': [{'name': n, 'host_ms': 1.0, 'device_ms': 1.0, 'self_device_ms': 1.0}
                      for n in ('mte.train.loss', 'mte.train.backward')]}
    read = reader(metric).read
    assert read({'kind': kind, 'profile': {}, 'program_records': [request, step]}) is not None
    assert read({'kind': other, 'profile': {}, 'program_records': [request, step]}) is None
    assert read({'kind': kind, 'program_records': [request, step]}) is None
    assert read({'kind': kind, 'profile': {}, 'program_records': []}) is None
    from mindtheedge_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, 'records')
    assert read({'kind': kind, 'profile': {}}) is None
