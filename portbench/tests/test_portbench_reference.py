"""The plain reference follows the program where both compute the same
function in fp32: the serving forward, NMS and wire bit for bit on the
CPU at tiny shapes, and the paper's training step (flip and dropout
draws, both passes, the losses, the backward, Adam) to fp32 rounding."""

import json

from portbench.tests.tiny import dry_run


def test_serving_agrees_exactly():
    checks = json.loads(dry_run('san.serve.b4', 5, 0))['checks']
    assert all(c['value'] <= 0.0 for c in checks.values()), checks


def test_training_step_in_fp32(monkeypatch):
    from portbench.tests import tiny
    shrink = tiny.shrink

    def fp32(config, traffic):
        shrink(config, traffic)
        config['train']['arch']['precision'] = 'float32'

    monkeypatch.setattr(tiny, 'shrink', fp32)
    line = json.loads(dry_run('san.train.b3.bf16', 12345, 0))
    numbers = dict(line['readings'], **{k: c['value'] for k, c in line['checks'].items()})
    assert numbers['loss_gap'] < 1e-4
    assert numbers['grad_gap'] < 1e-3
    assert numbers['update_gap'] < 1e-3
    assert numbers['stats_gap'] < 1e-5
