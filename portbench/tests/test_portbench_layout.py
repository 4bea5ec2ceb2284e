"""Every cell's files resolve by name from BENCHMARK.json, and the file
keeps to the shapes the benchmark's contract fixes."""

import json
import re

import pytest

from portbench.common import HERE, ROOT, benchmark, cell_files, metrics_of

BENCH = benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [c['name'] for c in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    names = [m['name'] for m in metrics] + CELLS + [c['name'] for c in BENCH['configs']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher'), m
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25, m
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert set(m['workloads']) <= set(CELLS), m
        moved = next(e for e in BENCH['end_to_end'] if e['name'] == m['moves'])
        for cell in m['workloads']:
            assert cell in moved.get('workloads', CELLS), (m['name'], cell)


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_resolve(cell):
    entry, config, traffic = cell_files(cell)
    assert entry['chips'] == 1 and len(entry['why']) <= 200
    conf = next(c for c in BENCH['configs'] if c['name'] == entry['config'])
    assert (ROOT / conf['file']).is_file() and conf['file'].startswith('portbench/')
    assert config['name'] == conf['name'] and config['reduced'] == conf['reduced']
    assert (HERE / 'entries' / f'{traffic["entry"]}.py').is_file()
    e2e = metrics_of(cell, 'end_to_end')
    per_layer = metrics_of(cell, 'per_layer')
    assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2 and per_layer
    for m in e2e + per_layer:
        assert (HERE / 'metrics' / f'{m["name"]}.py').is_file(), m['name']
    assert traffic['check']['limits']


def test_every_config_is_used():
    used = {c['config'] for c in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    pairs = [(c['config'], c['traffic']) for c in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))


def test_reference_weights_match_the_port():
    """The reference's parameter list is the port's ``state_dict``, so the
    benchmark's one set of weights loads into both."""
    import torch
    from mindtheedge_tpu_torch.models.packnet import PackNetSAN
    from portbench.reference.packnet import param_specs
    config = json.loads((ROOT / BENCH['configs'][0]['file']).read_text())
    with torch.device('meta'):
        port = PackNetSAN(tuple(config['channels'])).state_dict()
    specs = {n: tuple(s) for n, s, _ in param_specs(config['channels'])}
    assert specs == {n: tuple(t.shape) for n, t in port.items()}
