"""Entry ``selfsup``: the configuration's self-supervised task (depth and
pose networks, the photometric loss) through
``training.train_step.make_train_step``, one step per timed unit.

Set-up builds the task (``build_task``), loads the benchmark's weights into
its depth and pose networks, makes the train state over both
(``create_train_state(..., pose_net=)``: one Adam, a depth and a pose
group) and the step, makes the pool of target and context frames on the
card and a generator of the draws (flip, dropout) from the seed, and drives
that same step through its first ``check.steps`` steps on distinct batches
of the pool.  It reads, as it goes, each step's loss, the depth network's 4
inverse depths of step 1 as it computed them (a forward hook, removed
after), the first gradient of every leaf of both networks from Adam's
state after step 1 (``exp_avg / (1 - beta1)``) and, after the last, each
leaf's change.  The window then goes on stepping the same state.

The check frees the program and runs the reference's steps
(``reference/selfsup.py``) from the same weights, batches and seed.  Any
other ``program`` than ``port`` puts the reference in the program's place:
``control`` (fp8 e4m3 on the depth network's conv operands), or a planted
fault: ``half_batch`` (half of each batch in the passes and the loss),
``half_loss`` (the passes on the whole batch, the loss over its first half
of the rows), ``one_context`` (the loss over the back context alone),
``no_automask`` (the unwarped contexts left out of the minimum).  Such a
run times nothing: its unit is empty.
"""

import statistics
import sys
import time

import torch

from portbench import flops_selfsup
from portbench.common import (leaf_gaps, norm, relative_gap, release, synchronize, task_config,
                              worst_leaf)
from portbench.reference import selfsup as ref
from portbench.reference.precision import control, tf32
from portbench.traffic import stream_seed
from portbench.traffic.selfsup import selfsup_pool

BETA1 = 0.9
ZERO_GRAD = 1e-3    # leaves whose first reference gradient is under this share of the median's


def inv_depth_gap(got, want):
    """The L2 norm of ``got - want`` over that of ``want``'s deviation from
    its mean, over the rows both have: how much of the map's structure the
    program misses."""
    n = min(len(got), len(want))
    got, want = got[:n], want[:n]
    return norm(got - want) / norm(want - want.mean())


def rows(batch, n):
    """The first ``n`` rows of every tensor of ``batch``, lists included."""
    return {k: [t[:n] for t in v] if isinstance(v, list) else v[:n] for k, v in batch.items()}


class Cell:
    kind = 'train'

    def __init__(self, config, traffic, seed, device, program='port'):
        self.device = torch.device(device)
        train = config['train']
        model = train['model']
        self.precision = train['arch']['precision']
        self.lr_depth = model['optimizer']['depth']['lr']
        self.lr_pose = model['optimizer']['pose']['lr']
        self.dropout = model['depth_net']['dropout']
        self.flip_prob = model['loss']['flip_lr_prob']
        self.channels = tuple(config['channels'])
        self.h, self.w = config['image_shape']
        self.images_per_unit = traffic['batch']
        self.steps = traffic['check']['steps']
        self.limits = traffic['check']['limits']
        self.sample_size = 0
        self.depth_w = ref.depth_weights(self.channels, stream_seed(seed, 'weights'), self.device)
        self.pose_w = ref.pose_weights(stream_seed(seed, 'weights') + 1, self.device)
        self.pool = selfsup_pool(traffic, self.h, self.w, seed, self.device)
        self.draw_seed = stream_seed(seed, 'draws')
        self.task = self.state = self.step = None
        self.warmup_s = 0.0
        if program == 'port':
            self._build_port(config)
        else:
            self.readings = self._reference_readings(program)

    def _build_port(self, config):
        from mindtheedge_tpu_torch.models.packnet import to_train_device
        from mindtheedge_tpu_torch.models.tasks import build_task
        from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
        cfg = task_config(config['train'])
        cfg.model.depth_net.channels = self.channels
        self.task = build_task(cfg, self.device)
        self.task.depth_net.load_state_dict(self.depth_w)
        self.task.pose_net.load_state_dict(self.pose_w)
        net = to_train_device(self.task.depth_net, self.device)
        self.state = create_train_state(cfg, net, pose_net=self.task.pose_net)
        self.step = make_train_step(self.task)
        self.gen = torch.Generator(device=self.device).manual_seed(self.draw_seed)
        params = dict(net.named_parameters())
        params.update({f'pose.{n}': p for n, p in self.task.pose_net.named_parameters()})
        start = dict(self.depth_w, **{f'pose.{n}': t for n, t in self.pose_w.items()})
        inv = []
        hook = net.register_forward_hook(
            lambda m, args, out: inv.extend(d.detach().float() for d in out['inv_depths']))
        losses, first = [], None
        t0 = time.perf_counter()
        for i in range(self.steps):
            metrics = self.step(self.state, self.pool[i], self.gen)
            losses.append(float(metrics['loss']))
            if first is None:
                hook.remove()
                opt_state = self.state.optimizer.state
                first = {n: norm(opt_state[p]['exp_avg'] / (1 - BETA1)) if p in opt_state
                         else 0.0 for n, p in params.items()}
        change = {n: norm(p - start[n]) for n, p in params.items()}
        self.readings = (losses, first, change, [d.permute(0, 3, 1, 2) for d in inv])
        synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

    def _reference_readings(self, program):
        """The reference's readings in fp32 with TF32 off, or with the
        control or a planted fault in the program's place (the module's
        docstring)."""
        quant, batches, kwargs = None, self.pool[:self.steps], {}
        half = max(1, self.images_per_unit // 2)
        if program == 'control':
            quant, tf32_on = control(self.precision)
            if tf32_on:
                raise ValueError('the selfsup cell states bf16; its control is fp8')
        elif program == 'half_batch':
            batches = [rows(b, half) for b in batches]
        elif program == 'half_loss':
            kwargs['loss_rows'] = half
        elif program == 'one_context':
            kwargs['contexts'] = 1
        elif program == 'no_automask':
            kwargs['automask_loss'] = False
        elif program != 'reference':
            raise ValueError(f'unknown program {program!r}')
        with tf32(False):
            return ref.run_steps(self.depth_w, self.pose_w, batches, self.channels,
                                 self.draw_seed, self.lr_depth, self.lr_pose, quant=quant,
                                 rate=self.dropout, flip_prob=self.flip_prob, **kwargs)

    def unit(self, i):
        if self.step is not None:
            self.step(self.state, self.pool[(self.steps + i) % len(self.pool)], self.gen)

    def attach(self, spans):
        """The program's own spans are what this cell's readers read."""

    def flops_per_unit(self):
        return flops_selfsup.selfsup_train_flops(self.channels, self.h, self.w,
                                                 self.images_per_unit)

    def nms_per_unit(self):
        return 0, 0.0

    def release(self):
        self.task = self.state = self.step = None
        release(self.device)

    def check(self, samples=None):
        self.release()
        losses, first, change, inv = self.readings
        torch.backends.cudnn.benchmark = False      # the reference's shapes: no autotuning
        r_losses, r_first, r_change, r_inv = self._reference_readings('reference')
        median_grad = sorted(r_first.values())[len(r_first) // 2]
        moving = [k for k, g in r_first.items() if g >= ZERO_GRAD * median_grad]
        print(f'reading losses: program {losses}, reference {r_losses}', file=sys.stderr)
        gaps = [relative_gap(a, b) for a, b in zip(losses, r_losses)]
        grads = sorted(leaf_gaps(first, r_first, moving).values())
        pose = [k for k in moving if k.startswith('pose.')]
        numbers = {'inv_depth_gap': max(inv_depth_gap(a, b) for a, b in zip(inv, r_inv)),
                   'first_loss_gap': gaps[0], 'loss_gap': max(gaps),
                   'grad_median_gap': statistics.median(grads),
                   'grad_p90_gap': grads[int(0.9 * (len(grads) - 1))],
                   'pose_grad_gap': worst_leaf(first, r_first, pose)[0]}
        for what, prog, rf in (('grad', first, r_first), ('update', change, r_change)):
            numbers[f'{what}_gap'], leaf = worst_leaf(prog, rf, moving)
            print(f'reading {what}_gap at {leaf}: program {prog[leaf]:.6g}, '
                  f'reference {rf[leaf]:.6g}', file=sys.stderr)
        return numbers
