"""The self-supervised cell ``packnet01.selfsup.b3.bf16`` on the CPU at tiny
shapes (64x96, batch 2, the configuration's widths), with its committed
limits: a traced dry run is correct and reads the cell's three readers;
the control (fp8 on the depth network's convs) and each planted fault
(half the batch, the loss over half the rows, one context, no automask)
fail a limit.  Its FLOP count equals PyTorch's over the port's networks,
and its reference weights load into the port's PackNet01 and PoseNet."""

import json
import math

import pytest
import torch

from portbench.common import HERE, cell_files, load_module

CELL = 'packnet01.selfsup.b3.bf16'
SEED = 2 ** 31 + 29
READERS = ['photometric_ms.train', 'warp_ms.train', 'pose_ms.train']


def test_traced_dry_run_is_correct_and_reads_its_spans():
    from portbench.tests.tiny import dry_run
    line = json.loads(dry_run(CELL, SEED, 1))
    assert line['correct'] is True
    for metric in READERS + ['mfu.train', 'loss_ms.train', 'backward_ms.train']:
        value = line['metrics'][metric]['value']
        assert math.isfinite(value) and value > 0, (metric, value)
    assert line['metrics']['warp_ms.train']['value'] <= line['metrics']['photometric_ms.train'][
        'value']


@pytest.mark.parametrize('program', ['control', 'half_batch', 'half_loss', 'one_context',
                                     'no_automask'])
def test_control_and_faults_fail_a_limit(program):
    from portbench.tests.tiny import shrink
    torch.set_num_threads(2)
    _, config, traffic = cell_files(CELL)
    shrink(config, traffic)
    entry = load_module(HERE / 'entries' / 'selfsup.py')
    numbers = entry.Cell(config, traffic, SEED, 'cpu', program).check()
    limits = traffic['check']['limits']
    assert any(numbers[k] > limit for k, limit in limits.items()), numbers


def test_flops_are_pytorchs():
    """Forward and backward of PackNet01 and PoseNet on images that take no
    gradient, counted by FlopCounterMode, against ``flops_selfsup``."""
    from torch.utils.flop_counter import FlopCounterMode
    from mindtheedge_tpu_torch.models.packnet import PackNet01
    from mindtheedge_tpu_torch.models.posenet import PoseNet
    from portbench.flops_selfsup import selfsup_train_flops
    torch.manual_seed(0)
    channels, b, h, w = (16,) * 6, 2, 64, 96
    depth, pose = PackNet01(channels).train(), PoseNet()
    rgb = torch.rand(b, h, w, 3)
    contexts = [torch.rand(b, h, w, 3) for _ in range(2)]
    with FlopCounterMode(display=False) as counter:
        loss = sum(d.sum() for d in depth(rgb)['inv_depths']) + pose(rgb, contexts).sum()
        loss.backward()
    assert selfsup_train_flops(channels, h, w, b) == counter.get_total_flops()


def test_reference_weights_are_the_ports():
    """The reference's weights load into the port's networks: the same
    names and shapes (at small widths; the names do not depend on them)."""
    from mindtheedge_tpu_torch.models.packnet import PackNet01
    from mindtheedge_tpu_torch.models.posenet import PoseNet
    from portbench.reference.selfsup import depth_weights, pose_weights
    channels = (16,) * 6
    for ref, port in ((depth_weights(channels, 1, 'cpu'), PackNet01(channels)),
                      (pose_weights(1, 'cpu'), PoseNet())):
        assert {n: t.shape for n, t in ref.items()} == \
            {n: t.shape for n, t in port.state_dict().items()}
