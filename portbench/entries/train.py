"""Entry ``train``: the configuration's task through
``training.train_step.make_train_step``, one step per timed unit.

Set-up builds the task with the benchmark's weights, its train state
(Adam) and the step, makes the batch pool on the card and a generator of
the draws (flip, dropout) from the seed, and drives that same step through
its first ``check.steps`` steps on distinct batches of the pool, the
window's own call and feed.  It reads, as it goes, each step's loss, the
first gradient from Adam's state after step 1 (``exp_avg / (1 - beta1)``)
and, after the last, each leaf's change and each running statistic's
change.  The window then goes on stepping the same state.

The check frees the program and runs the reference's steps from the same
weights, batches and seed.
"""

import statistics
import sys
import time

import torch

from portbench import flops
from portbench.common import (leaf_gaps, norm, relative_gap, release, synchronize, task_config,
                              worst_leaf)
from portbench.reference import packnet as ref_net
from portbench.reference import train as ref_train
from portbench.reference.precision import control, tf32
from portbench.traffic import stream_seed, train_pool

BETA1 = 0.9
ZERO_GRAD = 1e-3    # leaves whose first reference gradient is under this share of the median's


class Cell:
    kind = 'train'

    def __init__(self, config, traffic, seed, device, program='port'):
        self.device = torch.device(device)
        train = config['train']
        self.precision = train['arch']['precision']
        self.lr = train['model']['optimizer']['depth']['lr']
        self.dropout = train['model']['depth_net']['dropout']
        self.flip_prob = train['model']['loss']['flip_lr_prob']
        self.channels = tuple(config['channels'])
        self.h, self.w = config['image_shape']
        self.images_per_unit = traffic['batch']
        self.steps = traffic['check']['steps']
        self.limits = traffic['check']['limits']
        self.sample_size = 0
        self.weights = ref_net.make_weights(self.channels, stream_seed(seed, 'weights'), self.device)
        self.pool = train_pool(traffic, self.h, self.w, seed, self.device)
        self.draw_seed = stream_seed(seed, 'draws')
        self.task = self.state = None
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
        self.task = build_task(cfg, self.device)
        self.task.depth_net.load_state_dict(self.weights)
        net = to_train_device(self.task.depth_net, self.device)
        self.state = create_train_state(cfg, net)
        self.step = make_train_step(self.task)
        self.gen = torch.Generator(device=self.device).manual_seed(self.draw_seed)
        params = dict(net.named_parameters())
        names = {p: n for n, p in params.items()}
        losses, first = [], None
        t0 = time.perf_counter()
        for i in range(self.steps):
            metrics = self.step(self.state, self.pool[i], self.gen)
            losses.append(float(metrics['loss']))
            if first is None:
                opt_state = self.state.optimizer.state
                first = {names[p]: norm(opt_state[p]['exp_avg'] / (1 - BETA1)) if p in opt_state
                         else 0.0 for p in params.values()}
        change = {n: norm(p - self.weights[n]) for n, p in params.items()}
        stats = {n: norm(b - self.weights[n]) for n, b in net.named_buffers()
                 if ref_train.is_stat(n) and b.is_floating_point()}
        self.readings = (losses, first, change, stats)
        synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

    def _reference_readings(self, program):
        """The reference's readings: in fp32 with TF32 off; in the program's
        place (``program`` 'control'), in the precision below the
        configuration's; with a planted fault, on the first half of each
        batch ('half_batch': both passes and the losses) or with the losses'
        mean over the first half of the rows that the passes see
        ('half_loss')."""
        quant, tf32_on, batches, rows = None, False, self.pool[:self.steps], None
        half = max(1, self.images_per_unit // 2)
        if program == 'control':
            quant, tf32_on = control(self.precision)
        elif program == 'half_batch':
            batches = [{k: v[:half] for k, v in b.items()} for b in batches]
        elif program == 'half_loss':
            rows = half
        elif program != 'reference':
            raise ValueError(f'unknown program {program!r}')
        with tf32(tf32_on):
            return ref_train.run_steps(self.weights, batches, self.channels, self.draw_seed,
                                       self.lr, quant=quant, rate=self.dropout,
                                       flip_prob=self.flip_prob, loss_rows=rows)

    def unit(self, i):
        self.step(self.state, self.pool[(self.steps + i) % len(self.pool)], self.gen)

    def attach(self, spans):
        spans.hook_module(self.task.depth_net, 'network_fwd')
        opt = self.state.optimizer
        opt.register_step_pre_hook(lambda *a: spans.mark('optimizer'))
        opt.register_step_post_hook(lambda *a: spans.mark('optimizer'))

    def flops_per_unit(self):
        return sum(flops.packnet_train_flops(self.channels, self.h, self.w, b['input_depth'])
                   for b in self.pool) / len(self.pool)

    def nms_per_unit(self):
        return 0, 0.0

    def release(self):
        self.task = self.state = self.step = None
        release(self.device)

    def check(self, samples=None):
        self.release()
        losses, first, change, stats = self.readings
        torch.backends.cudnn.benchmark = False      # the reference's shapes: no autotuning
        r_losses, r_first, r_change, r_stats = self._reference_readings('reference')
        median_grad = sorted(r_first.values())[len(r_first) // 2]
        moving = [k for k, g in r_first.items() if g >= ZERO_GRAD * median_grad]
        print(f'reading losses: program {losses}, reference {r_losses}', file=sys.stderr)
        gaps = [relative_gap(a, b) for a, b in zip(losses, r_losses)]
        grads = sorted(leaf_gaps(first, r_first, moving).values())
        numbers = {'first_loss_gap': gaps[0], 'loss_gap': max(gaps),
                   'grad_median_gap': statistics.median(grads),
                   'grad_p90_gap': grads[int(0.9 * (len(grads) - 1))]}
        for what, prog, ref, leaves in (('grad', first, r_first, moving),
                                        ('update', change, r_change, moving),
                                        ('stats', stats, r_stats, None)):
            numbers[f'{what}_gap'], leaf = worst_leaf(prog, ref, leaves)
            print(f'reading {what}_gap at {leaf}: program {prog[leaf]:.6g}, '
                  f'reference {ref[leaf]:.6g}', file=sys.stderr)
        return numbers
