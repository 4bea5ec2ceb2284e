"""A run with the timed path broken underneath comes out not correct: the
whole run but the look for a card, on the CPU at tiny shapes, with the
cells' committed limits.  One fault per kind the cell can have: an answer
altered where it is produced (the serving cells); a step that leaves the
state unchanged, and half of the batch left out with the mean taken over
the rest, in both passes and in the losses alone (the training cell).
With one chip there is no exchange to leave out."""

import json

import pytest
import torch

from portbench.tests.tiny import dry_run


def run(cell):
    return json.loads(dry_run(cell, 2 ** 31 + 23, 0))


def test_sound_runs_are_correct():
    assert run('san.serve.b4')['correct'] is True


@pytest.mark.parametrize('cell', ['san.serve.b4', 'san.serve.b4.bf16'])
@pytest.mark.parametrize('part', ['depth', 'edges'])
def test_served_answer_altered(monkeypatch, cell, part):
    from mindtheedge_tpu_torch import serve
    original = serve.serve

    def altered(*args, **kwargs):
        depth, edges = original(*args, **kwargs)
        if part == 'depth':
            depth = depth.to(torch.int32)
            depth[:, :16, :16] //= 2
            depth = depth.to(torch.uint16)
        else:
            edges = edges.clone()
            edges[:, :16, :2] ^= 0xFF
        return depth, edges

    monkeypatch.setattr(serve, 'serve', altered)
    assert run(cell)['correct'] is False


def test_train_state_unchanged(monkeypatch):
    original = torch.optim.Adam.step

    def unchanged(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups for p in g['params']]
        out = original(self, closure)
        with torch.no_grad():
            for p, q in zip((p for g in self.param_groups for p in g['params']), saved):
                p.copy_(q)
        return out

    monkeypatch.setattr(torch.optim.Adam, 'step', unchanged)
    line = run('san.train.b3.bf16')
    assert line['correct'] is False
    assert line['checks']['update_gap']['value'] == pytest.approx(1.0)


def test_train_half_batch(monkeypatch):
    from mindtheedge_tpu_torch.models import tasks
    original = tasks.SemiSupEdgeTask.train_loss

    def half(self, batch, generator=None, progress=0.0):
        b = batch['rgb'].shape[0] // 2
        return original(self, {k: v[:b] for k, v in batch.items()}, generator, progress)

    monkeypatch.setattr(tasks.SemiSupEdgeTask, 'train_loss', half)
    assert run('san.train.b3.bf16')['correct'] is False


def test_train_half_loss(monkeypatch):
    """The passes see the whole batch; the losses take their mean over the
    first half of its rows, so the forward's statistics are sound."""
    from mindtheedge_tpu_torch.models import tasks
    original = tasks.SemiSupEdgeTask.losses

    def half(self, batch, out):
        b = batch['rgb'].shape[0] // 2
        out = dict(out, inv_depths=[d[:b] for d in out['inv_depths']])
        return original(self, {k: v[:b] for k, v in batch.items()}, out)

    monkeypatch.setattr(tasks.SemiSupEdgeTask, 'losses', half)
    line = run('san.train.b3.bf16')
    assert line['correct'] is False
    assert line['checks']['stats_gap']['value'] <= line['checks']['stats_gap']['limit']
