"""The port's self-supervised training step (``SelfSupTask`` with
``PackNet01`` and ``PoseNet``, the multi-view photometric loss, through
``make_train_step``) against the benchmark's plain reference
(``portbench/reference/selfsup.py``) on the CPU, in fp32: the benchmark
configuration ``packnet01_selfsup_kitti_hr`` at channels (16,)*6, 64x96,
batch 2, two contexts, on the same seeded weights, frames and draws.

Compared: the loss; every leaf's gradient, the pose network's included;
the parameters after one Adam update.  Tolerances:

* loss: relative 1e-5.  The two compute the same fp32 functions in
  another order (the port pools SSIM's five moments in one call, works
  NHWC and takes ``amin``); their losses agree to ~1e-7.
* gradients: each element within 1e-4 of its leaf's largest |gradient|,
  the noise of fp32 sums through ~40 layers (as the port's other training
  parity tests hold it).  At (16,)*6 every GroupNorm group is one channel,
  so the conv biases in front of one have analytically zero gradients
  (rounding noise, 1e-13-1e-8 against a median leaf's 2e-5, on either
  side): a leaf whose largest reference |gradient| is under 1e-3 of the
  median leaf's must be under it in the port too.
* the update: Adam's first step is ``lr * g / (|g| + eps)``, about
  ``lr * sign(g)``, so an element whose gradient sits at the noise level
  may move by ``lr`` either way, and one near Adam's eps (1e-8, against
  leaves' largest of 1e-6-1e-4) by a share of it; elements whose
  reference gradient is above 1e-2 of the leaf's largest must land alike
  to 1e-3 of ``lr`` beyond two fp32 spacings of the new value (the two
  Adams round it in another order: one spacing of 1.0 is 6e-4 of ``lr``).

A planted fault, the reference with the automask candidates dropped, fails
the comparison: the loss alone moves by percents.
"""

import json
import statistics

import pytest
import torch

from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from portbench.common import ROOT
from portbench.reference import selfsup as ref
from portbench.reference.train import Adam
from portbench.traffic.selfsup import selfsup_pool

torch.set_num_threads(1)

CHANNELS = (16,) * 6
B, H, W = 2, 64, 96
SEED = 2 ** 31 + 7
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4         # of a leaf's largest |gradient|
UPDATE_TOL = 1e-3       # of lr, where the gradient is above the noise
LIVE = 1e-2             # a gradient above this share of its leaf's largest
ZERO_LEAF = 1e-3        # a leaf under this share of the median leaf's largest is zero
CONFIG = ROOT / 'portbench' / 'configs' / 'packnet01_selfsup_kitti_hr.json'
TRAFFIC = ROOT / 'portbench' / 'workloads' / 'train.selfsup.b3.bf16.json'


def selfsup_setup(flip_prob=0.5):
    """The benchmark's configuration at the small size, fp32 -> (task,
    state, step, batch, depth weights, pose weights, config)."""
    config = json.loads(CONFIG.read_text())
    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(config['train'])
    cfg.arch.precision = 'float32'
    cfg.model.depth_net.channels = CHANNELS
    cfg.model.loss.flip_lr_prob = flip_prob
    traffic = dict(json.loads(TRAFFIC.read_text()), batch=B, pool=1)
    batch = selfsup_pool(traffic, H, W, SEED, 'cpu')[0]
    wd = ref.depth_weights(CHANNELS, SEED, 'cpu')
    wp = ref.pose_weights(SEED + 1, 'cpu')
    task = build_task(cfg, device='cpu')
    task.depth_net.load_state_dict(wd)
    task.pose_net.load_state_dict(wp)
    state = create_train_state(cfg, task.depth_net.train(), pose_net=task.pose_net)
    return task, state, make_train_step(task), batch, wd, wp, cfg


def port_step(flip_prob):
    """One port step -> (loss, {leaf: gradient}, {leaf: value after})."""
    task, state, step, batch, _, _, _ = selfsup_setup(flip_prob)
    metrics = step(state, batch, torch.Generator().manual_seed(SEED))
    named = dict(state.net.named_parameters())
    named.update({f'pose.{n}': p for n, p in task.pose_net.named_parameters()})
    return (float(metrics['loss']), {n: p.grad.clone() for n, p in named.items()},
            {n: p.detach().clone() for n, p in named.items()})


def reference_step(flip_prob, **fault):
    _, _, _, batch, wd, wp, cfg = selfsup_setup(flip_prob)
    wd = {k: v.clone().requires_grad_(True) for k, v in wd.items()}
    wp = {k: v.clone().requires_grad_(True) for k, v in wp.items()}
    total, _ = ref.loss(wd, wp, batch, CHANNELS, torch.Generator().manual_seed(SEED),
                        flip_prob=flip_prob, **fault)
    leaves = dict(wd, **{f'pose.{k}': v for k, v in wp.items()})
    grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
    opt = Adam(list(leaves.values()), cfg.model.optimizer.depth.lr)
    opt.step(list(grads.values()))
    return float(total.detach()), grads, {n: p.detach().clone() for n, p in leaves.items()}


def gaps(port, reference, lr):
    """(relative loss gap, worst gradient gap over its leaf's largest,
    worst update gap over lr where the gradient is live)."""
    (loss, grads, after), (r_loss, r_grads, r_after) = port, reference
    tops = {n: float(g.abs().max()) for n, g in r_grads.items()}
    floor = ZERO_LEAF * statistics.median(tops.values())
    grad_gap = update_gap = 0.0
    for name, g in r_grads.items():
        if tops[name] < floor:          # analytically zero: noise on both sides
            grad_gap = max(grad_gap, float(grads[name].abs().max()) / floor * GRAD_TOL)
            continue
        grad_gap = max(grad_gap, float((grads[name] - g).abs().max()) / tops[name])
        live = g.abs() > LIVE * tops[name]
        slack = 2 * torch.finfo(torch.float32).eps * r_after[name].abs()
        excess = (after[name] - r_after[name]).abs() - slack
        update_gap = max(update_gap, float(excess[live].max()) / lr)
    return abs(loss - r_loss) / abs(r_loss), grad_gap, update_gap


@pytest.fixture(scope='module')
def lr():
    return selfsup_setup()[-1].model.optimizer.depth.lr


@pytest.mark.parametrize('flip_prob', [0.0, 1.0], ids=['unflipped', 'flipped'])
def test_step_matches_reference(flip_prob, lr):
    loss_gap, grad_gap, update_gap = gaps(port_step(flip_prob), reference_step(flip_prob), lr)
    assert loss_gap < LOSS_RTOL
    assert grad_gap < GRAD_TOL
    assert update_gap < UPDATE_TOL


def test_no_automask_reference_fails(lr):
    loss_gap, grad_gap, _ = gaps(port_step(0.0), reference_step(0.0, automask_loss=False), lr)
    assert loss_gap > 100 * LOSS_RTOL and grad_gap > GRAD_TOL
