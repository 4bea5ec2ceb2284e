"""Task models: counterpart of ``mindtheedge_tpu/models/tasks.py``
(``TASK_REGISTRY``, ``build_task``, ``build_depth_net`` ``:33-88``;
``BaseTask.run_depth`` / ``infer`` / the loss pieces ``:180-303``;
``SemiSupTask`` and ``SemiSupEdgeTask`` ``:327-419``;
``EdgeEstimationLIDARTask`` ``:471-511``).

A task holds its depth network, an ``nn.Module`` on its device, and its
model's input, output and loss conventions.  Inputs and outputs are NHWC,
as in the JAX package.  ``train_loss(batch, generator, progress)`` returns
``(loss, metrics)``: the network's output dict is dropped inside, so the
graph of the RGBD pass, whose outputs no ported loss reads, is freed
before the backward.  Random draws (the lr-flip and dropout) come from the
caller's ``torch.Generator`` on the task's device.

Not ported yet, each raising with its ROADMAP Queue 1 item: the
self-supervised (photometric) part of the semi-supervised losses, i.e.
``supervised_loss_weight != 1`` (item 16); ``EdgeEstimationLIDARTask``
training (item 21); the other tasks (item 22); bf16 (item 9).
"""

import torch

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.losses.grad_loss import grad_loss
from mindtheedge_tpu_torch.losses.supervised import supervised_loss
from mindtheedge_tpu_torch.models.model_utils import upsample_output
from mindtheedge_tpu_torch.models.packnet import PackNetSAN, init_weights, to_device
from mindtheedge_tpu_torch.training.checkpoint import restore_depth_net
from mindtheedge_tpu_torch.utils.depth import depth2inv, inv2depth
from mindtheedge_tpu_torch.utils.image import flip_lr

TASK_REGISTRY = {}


def register_task(name):
    def deco(cls):
        TASK_REGISTRY[name] = cls
        return cls
    return deco


def build_task(config, device=None, ckpt=None):
    """The task named by ``config.model.name`` (``tasks.py:43-49``), its
    network drawn from ``config.arch.seed`` and then restored from ``ckpt``
    where one is given, on ``device`` (``None`` -> CUDA), in eval mode."""
    name = config.model.name
    if name not in TASK_REGISTRY:
        raise KeyError(f'Unknown model {name}; the port has '
                       f'{sorted(TASK_REGISTRY)} (the other tasks wait for '
                       'ROADMAP Queue 1 items 16 and 22)')
    return TASK_REGISTRY[name](config, device, ckpt)


def build_depth_net(cfg):
    """The depth network of ``config.model.depth_net`` (``tasks.py:68-87``)."""
    if cfg.name in ('PackNetSAN01', 'PackNetSlimEnc01'):  # ckpt-name bypass
        extra = {'channels': tuple(cfg.channels)} if cfg.get('channels') else {}
        return PackNetSAN(version=cfg.version or '1A',
                          input_channels=cfg.input_channels,
                          output_channels=cfg.output_channels,
                          dropout=cfg.dropout or None,
                          remat=cfg.get('remat', False) or False,
                          freeze_encoder=cfg.freeze_encoder,
                          freeze_decoder=cfg.freeze_decoder,
                          freeze_san=cfg.freeze_san, **extra)
    if cfg.name in ('PackNet01', 'PackNetSlim01'):
        raise NotImplementedError(
            f'{cfg.name} waits for ROADMAP Queue 1 item 10')
    raise NotImplementedError(
        f'depth network {cfg.name!r} is not ported (ROADMAP Queue 1 item 16)')


def _maybe_flip(x, flip):
    """``x`` flipped left-right where ``flip`` holds: None (never), True
    (always) or a device boolean, applied without a host sync."""
    if flip is None:
        return x
    if flip is True:
        return flip_lr(x)
    return torch.where(flip, flip_lr(x), x)


class BaseTask:
    """The depth forward with its lr-flip wrapper, and the loss pieces."""

    # batch keys forwarded to the depth net (reference _input_keys)
    input_keys = ('rgb', 'input_depth', 'rgb_edge')

    def __init__(self, config, device=None, ckpt=None):
        if getattr(config.arch, 'precision', 'float32') == 'bfloat16':
            raise NotImplementedError(
                'arch.precision bfloat16 waits for ROADMAP Queue 1 item 9')
        self.config = config
        mloss = config.model.loss
        self.flip_lr_prob = mloss.flip_lr_prob
        self.upsample_depth_maps = mloss.upsample_depth_maps
        self.supervised_method = mloss.supervised_method
        self.supervised_num_scales = mloss.supervised_num_scales
        self.supervised_loss_weight = mloss.supervised_loss_weight
        self.all_scales_edge = mloss.edges_depth_edge_loss_all_scales
        self.depth_edges_loss_weight = mloss.depth_edges_loss_weight
        self.edge_cfg = config.edges
        device = resolve_device(device)
        net = init_weights(build_depth_net(config.model.depth_net),
                           config.arch.seed)
        if ckpt is not None:
            restore_depth_net(net, ckpt)
        self.depth_net = to_device(net, device)
        self.device = device

    def run_depth(self, batch, force_flip=False, train=False, generator=None):
        """Depth net with the lr-flip wrapper (``tasks.py:180-244``).

        ``batch['rgb']`` [B,H,W,3] and, if present, ``batch['input_depth']``
        [B,H,W,1] -> the network's output dict, NHWC.  The network is put
        into ``train`` mode here.  At eval (no autograd) ``force_flip`` runs
        it on the lr-flipped inputs and flips its outputs back.  In
        training, one Bernoulli(``flip_lr_prob``) draw from ``generator``
        flips the whole batch, on the device; at ``flip_lr_prob`` 0 nothing
        is drawn.  ``upsample_depth_maps`` then brings every training scale
        to full resolution.  The 4-channel ``rgb_edge`` input is not ported
        (the network raises at build for ``input_channels == 4``), so
        ``rgb_edge`` does not reach the network.
        """
        self.depth_net.train(train)
        flip = None
        if train and self.flip_lr_prob > 0:
            flip = torch.rand((), device=self.device,
                              generator=generator) < self.flip_lr_prob
        elif not train and force_flip:
            flip = True
        rgb = _maybe_flip(batch['rgb'], flip)
        lidar = batch.get('input_depth')
        lidar = None if lidar is None else _maybe_flip(lidar, flip)
        with torch.set_grad_enabled(train):
            out = self.depth_net(rgb, lidar, generator)
            for key in ('inv_depths', 'inv_depths_rgbd'):
                if key in out:
                    out[key] = [_maybe_flip(d, flip) for d in out[key]]
            if train and self.upsample_depth_maps:
                out = upsample_output(out)
        return out

    def infer(self, batch, force_flip=False):
        return self.run_depth(batch, force_flip=force_flip)

    # -- loss pieces -----------------------------------------------------------
    def check_trainable(self):
        """Raise for what ``train_loss`` cannot run yet, before any work."""
        raise NotImplementedError(
            f'{type(self).__name__} training waits for ROADMAP Queue 1 item 22')

    def train_loss(self, batch, generator=None, progress=0.0):
        self.check_trainable()

    def _supervised(self, inv_depths, gt_depth):
        return supervised_loss(
            inv_depths, depth2inv(gt_depth),
            supervised_method=self.supervised_method,
            num_scales=self.supervised_num_scales)

    def _edge_loss_all_scales(self, depths_or_probs, batch, seg_mask,
                              is_grad, is_sigmoid, sigmoid_thresh=4.0,
                              use_normals=True, convert_to_depth=True):
        """``compute_edge_loss_with_all_scales`` (``tasks.py:276-303``,
        reference ``SemiSupEdgeModel.py:164-198``): GradLoss against
        ``edge`` / ``edge_{1,2,3}`` with ``normal`` / ``normal_{1,2,3}``,
        scale 0 alone or the mean of all 4."""
        def one(scale, edge_key, normal_key):
            x = depths_or_probs[scale]
            if convert_to_depth:
                x = inv2depth(x)
            normals = batch.get(normal_key) if use_normals else None
            loss, _ = grad_loss(
                x, batch[edge_key], gt_mask=seg_mask, is_grad=is_grad,
                is_sigmoid=is_sigmoid, sigmoid_thresh=sigmoid_thresh,
                gt_normals=normals,
                edge_loss_type=self.edge_cfg.edge_loss_type,
                weight=self.edge_cfg.depth_edges_loss_weight,
                pos_to_neg_weight=self.edge_cfg.depth_edge_loss_pos_to_neg_weight)
            return loss

        total = one(0, 'edge', 'normal')
        if self.all_scales_edge:
            for s in range(1, 4):
                total = total + one(s, f'edge_{s}', f'normal_{s}')
            total = total / 4.0
        return total


@register_task('SemiSupModel')
class SemiSupTask(BaseTask):
    """(1-w)*selfsup + w*supervised (``tasks.py:327-348``); only w = 1, the
    purely supervised form, is ported."""

    def check_trainable(self):
        if self.supervised_loss_weight != 1.0:
            raise NotImplementedError(
                f'{type(self).__name__} with supervised_loss_weight '
                f'{self.supervised_loss_weight} needs the pose net and the '
                'photometric loss: ROADMAP Queue 1 item 16')

    def train_loss(self, batch, generator=None, progress=0.0):
        self.check_trainable()
        out = self.run_depth(batch, train=True, generator=generator)
        sup = self._supervised(out['inv_depths'], batch['depth'])
        loss = self.supervised_loss_weight * sup
        return loss, {'supervised_loss': sup.detach(), 'loss': loss.detach()}


@register_task('SemiSupEdgeModel')
class SemiSupEdgeTask(SemiSupTask):
    """The paper's training model (``tasks.py:382-419``, reference
    ``SemiSupEdgeModel.py:98-162``): w * supervised + edge_w * GradLoss over
    the scales.  The edge term is gated on ``edges.train_depth_edges``; off,
    it reports 0."""

    def train_loss(self, batch, generator=None, progress=0.0):
        self.check_trainable()
        out = self.run_depth(batch, train=True, generator=generator)
        if self.edge_cfg.train_depth_edges:
            edge = self.depth_edges_loss_weight * self._edge_loss_all_scales(
                out['inv_depths'], batch, batch.get('rgb_edge'),
                is_grad=True, is_sigmoid=True, sigmoid_thresh=4.0)
        else:
            edge = torch.zeros((), device=self.device)
        supervised = self.supervised_loss_weight * self._supervised(
            out['inv_depths'], batch['depth'])
        loss = supervised + edge
        return loss, {'edge_loss': edge.detach(),
                      'supervised_loss': supervised.detach(),
                      'loss': loss.detach()}


@register_task('EdgeEstimationLIDARModel')
class EdgeEstimationLIDARTask(BaseTask):
    """The DEE model (``tasks.py:471-511``): ``infer`` divides the LiDAR by
    200 and halves every scale into a [0, 1] edge probability.
    ``run_depth`` does neither: the annotation CLI divides the LiDAR itself
    when it reads it and halves each scale it uses.  Its training waits for
    ROADMAP Queue 1 item 21."""

    input_keys = ('rgb', 'input_depth')

    def check_trainable(self):
        raise NotImplementedError(
            'EdgeEstimationLIDARModel training (DEE) waits for ROADMAP '
            'Queue 1 item 21')

    def infer(self, batch, force_flip=False):
        batch = dict(batch)
        if batch.get('input_depth') is not None:
            batch['input_depth'] = batch['input_depth'] / 200.0
        out = self.run_depth(batch, force_flip=force_flip)
        out['inv_depths'] = [d / 2.0 for d in out['inv_depths']]
        return out
