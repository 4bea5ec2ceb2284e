"""A tiny-shape dry run of each cell on the CPU, through the NMS's plain
version, prints a well-formed last line; without a card the benchmark
refuses to run."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.common import ROOT, benchmark, metrics_of

CELLS = [c['name'] for c in benchmark()['workloads']]


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', CELLS)
def test_dry_run_line(cell, trace):
    from portbench.tests.tiny import dry_run
    line = json.loads(dry_run(cell, 2 ** 31 + 11, trace))
    keys = list(line)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert keys[-2:] == ['readings', 'checks']
    assert line['correct'] is True and line['attempted'] >= 1 and line['failed'] == 0
    kind = 'per_layer' if trace else 'end_to_end'
    wanted = {m['name']: m['unit'] for m in metrics_of(cell, kind)}
    assert set(line['metrics']) <= set(wanted)
    if not trace:       # every end-to-end metric but the device's peak, which a CPU lacks
        assert set(line['metrics']) == set(wanted) - {'train_peak_gib'}
    for name, m in line['metrics'].items():
        assert m['unit'] == wanted[name] and m['value'] == m['value']
    for c in line['checks'].values():
        assert set(c) == {'value', 'limit'}
    if trace:
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}


def _run(cwd):
    return subprocess.run([sys.executable, '-m', 'portbench.run', '--workload', CELLS[0],
                           '--seed', '1', '--seconds', '1', '--trace', '0'],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present: this test is of a run without one')
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ''


def test_benchmark_alone_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/ has no
    program to run."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ''
