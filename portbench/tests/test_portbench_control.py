"""On the card: each cell's control (the reference in the program's place,
in the precision below the configuration's) and the training cell's
half-batch faults (in both passes, and in the losses alone) fail at least
one of the cell's limits, at the cell's own size.

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""

import pytest

from portbench.common import benchmark, cell_files

CELLS = [c['name'] for c in benchmark()['workloads']]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    torch.backends.cudnn.benchmark = True


def fails(cell, program):
    from portbench.control import readings
    _, _, traffic = cell_files(cell)
    numbers = readings(cell, 2 ** 31 + 101, program, 3.0)
    limits = traffic['check']['limits']
    return {k: v for k, v in numbers.items() if k in limits and v > limits[k]}


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails(card, cell):
    assert fails(cell, 'control')


@pytest.mark.cuda
@pytest.mark.parametrize('fault', ['half_batch', 'half_loss'])
def test_half_batch_fails(card, fault):
    assert fails('san.train.b3.bf16', fault)
