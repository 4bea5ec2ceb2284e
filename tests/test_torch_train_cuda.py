"""One training step of ``SemiSupEdgeTask`` on the card against the same step
on the CPU, and a checkpoint round trip on the card; the helpers
``chip_smoke.py`` shares.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

Without a CUDA device the card tests skip.  Both sides start from the same
seeded weights and batch, at dropout 0 and ``flip_lr_prob`` 0, TF32 off;
the card's convs are cuDNN's, the CPU's ATen's, so they round differently.
Tolerances: the loss rtol 1e-4; each parameter's gradient within 1e-4 of
that tensor's largest |gradient|; the parameters after the Adam step
within lr * 1e-2; the SAN running statistics rtol 1e-4.  Two kinds of
values are rounding noise on both sides and are held to what noise allows
(``compare_states``): gradient tensors that vanish analytically, and the
Adam step of an element whose gradient lies inside that noise.
"""

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.training.checkpoint import (
    load_checkpoint, restore_train_state, save_checkpoint)
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step

LR = 1e-4


def train_config(channels=(16,) * 6, dropout=0.0, flip_lr_prob=0.0, seed=0):
    """The paper's training task (``SemiSupEdgeModel``, sparse-silog, GradLoss
    at 4 scales with normals, edge weight 10), built in code."""
    cfg = get_cfg_defaults()
    cfg.arch.seed = seed
    cfg.model.name = 'SemiSupEdgeModel'
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.version = '1A'
    cfg.model.depth_net.channels = tuple(channels)
    cfg.model.depth_net.dropout = dropout
    cfg.model.loss.supervised_method = 'sparse-silog'
    cfg.model.loss.supervised_num_scales = 1
    cfg.model.loss.supervised_loss_weight = 1.0
    cfg.model.loss.edges_depth_edge_loss_all_scales = True
    cfg.model.loss.upsample_depth_maps = False
    cfg.model.loss.flip_lr_prob = flip_lr_prob
    cfg.model.optimizer.depth.lr = LR
    cfg.edges.train_depth_edges = True
    cfg.edges.depth_edges_loss_weight = 10.0
    return cfg


def synthetic_batch(rng, b, h, w):
    """A numpy batch: RGB, a blocky depth scene, its GT 90 % and LiDAR 95 %
    sparse, its edges and normals (angles) at the 4 scales."""
    depth = np.full((b, h, w, 1), 30.0, np.float32)
    for i in range(b):
        for _ in range(3):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            depth[i, y:y + rng.randint(8, h // 2), x:x + rng.randint(8, w // 2)] = \
                rng.uniform(5, 25)
    batch = {'rgb': rng.rand(b, h, w, 3).astype(np.float32)}
    batch['depth'] = np.where(rng.rand(b, h, w, 1) < 0.9, 0.0, depth).astype(np.float32)
    batch['input_depth'] = np.where(rng.rand(b, h, w, 1) < 0.95, 0.0,
                                    depth).astype(np.float32)
    for s, key in enumerate(('', '_1', '_2', '_3')):
        d = depth[:, ::2 ** s, ::2 ** s]
        edge = (np.diff(d, axis=2, append=d[:, :, -1:]) != 0) | \
            (np.diff(d, axis=1, append=d[:, -1:]) != 0)
        batch['edge' + key] = edge.astype(np.float32)
        batch['normal' + key] = ((rng.rand(*d.shape) * 2 - 1) * np.pi).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def one_step(task, batch):
    """A fresh train state over the task's network, one step -> (state,
    metrics, parameters and buffers before the step)."""
    state = create_train_state(task.config, task.depth_net)
    before = {k: v.detach().clone() for k, v in task.depth_net.state_dict().items()}
    metrics = make_train_step(task)(state, batch, torch.Generator(task.device))
    return state, metrics, before


def compare_states(card, host, before, grad_rtol=1e-4):
    """Card vs CPU after one step -> the worst ratios found.  Gradients:
    each tensor within ``grad_rtol`` of its largest |gradient|; a tensor
    whose largest |gradient| on the CPU is below 1e-5 of the network's
    vanishes analytically (with (16,)*6 channels the GroupNorm has one
    channel per group, so the conv bias before it gets zero; the SAN
    ladder feeds no loss) and is held within 1e-5 of the network's.
    Parameters after the step: within lr * 1e-2, except where the CPU's
    |gradient| lies inside that noise (Adam's first step is then +-lr on
    either side); there |step| <= lr, give or take an ulp."""
    grads_c = {n: p.grad.cpu() for n, p in card.net.named_parameters()}
    grads_h = {n: p.grad for n, p in host.net.named_parameters()}
    top = max(float(g.abs().max()) for g in grads_h.values())
    worst_grad = worst_param = 0.0
    after_c = {k: v.cpu() for k, v in card.net.state_dict().items()}
    after_h = host.net.state_dict()
    for name, gh in grads_h.items():
        scale = float(gh.abs().max())
        vanishing = scale < 1e-5 * top
        tol = 1e-5 * top if vanishing else grad_rtol * scale
        err = float((grads_c[name] - gh).abs().max())
        assert err <= tol, f'gradient {name}: {err} > {tol}'
        if not vanishing:
            worst_grad = max(worst_grad, err / scale)
        noise = (torch.ones_like(gh, dtype=torch.bool) if vanishing
                 else gh.abs() <= grad_rtol * scale)
        off = (after_c[name] - after_h[name]).abs()
        assert bool((off[~noise] <= LR * 1e-2).all()), f'parameter {name}'
        worst_param = max(worst_param, float(off[~noise].max()) if (~noise).any() else 0.0)
        step = (after_c[name] - before[name]).abs()
        assert float(step.max()) <= LR * 1.001, f'parameter {name} moved by {float(step.max())}'
    for name, t in after_h.items():
        if name.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(after_c[name], t, rtol=1e-4, atol=1e-6,
                                       msg=lambda m, name=name: f'{name}: {m}')
    return {'grad_vs_max': worst_grad, 'param_vs_lr': worst_param / LR}


def train_step_card_vs_cpu(dev, channels=(16,) * 6, shape=(2, 64, 96)):
    """One ``train_step`` of the same seeded task and batch on ``dev`` and
    on the CPU -> (the CPU's and the card's loss, the worst ratios)."""
    cfg = train_config(channels)
    host_task = build_task(cfg, device='cpu')
    card_task = build_task(cfg, device=dev)
    card_task.depth_net.load_state_dict(host_task.depth_net.state_dict())
    batch = synthetic_batch(np.random.RandomState(0), *shape)
    card, m_card, _ = one_step(card_task, {k: v.to(dev) for k, v in batch.items()})
    host, m_host, before = one_step(host_task, batch)
    assert card.step == host.step == 1
    loss_h, loss_c = float(m_host['loss']), float(m_card['loss'])
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h), (loss_c, loss_h)
    for k in m_host:
        np.testing.assert_allclose(float(m_card[k]), float(m_host[k]), rtol=1e-4, err_msg=k)
    return loss_h, loss_c, compare_states(card, host, before)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda_card):
    train_step_card_vs_cpu(cuda_card)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_card, tmp_path):
    """A card state saved and restored into a fresh card state: the network
    bit-equal, the optimizer's moments and step counts, the scheduler, the
    epoch and step."""
    cfg = train_config()
    task = build_task(cfg, device=cuda_card)
    batch = {k: v.to(cuda_card) for k, v in
             synthetic_batch(np.random.RandomState(1), 2, 64, 96).items()}
    state, _, _ = one_step(task, batch)
    state.scheduler.step()
    state.epoch = 1
    path = save_checkpoint(str(tmp_path / 'card.ckpt'), cfg, state, {'loss': 1.0})
    fresh = build_task(cfg, device=cuda_card)
    restored = restore_train_state(create_train_state(cfg, fresh.depth_net),
                                   load_checkpoint(path))
    assert (restored.epoch, restored.step) == (1, 1)
    for (k, a), b in zip(state.net.state_dict().items(),
                         restored.net.state_dict().values()):
        assert torch.equal(a, b), k
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, s in want['state'].items():
        for key in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(s[key].cpu(), got['state'][i][key].cpu()), (i, key)
    assert restored.scheduler.state_dict() == state.scheduler.state_dict()
    assert restored.optimizer.param_groups[0]['lr'] == state.optimizer.param_groups[0]['lr']
