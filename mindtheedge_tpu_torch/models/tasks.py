"""Task models: counterpart of ``mindtheedge_tpu/models/tasks.py``
(``TASK_REGISTRY``, ``build_task``, ``build_depth_net``,
``build_pose_net`` ``:33-95``; ``BaseTask.run_depth`` / ``run_pose`` /
``infer`` / the loss pieces ``:180-303``; the training tasks ``:306-634``).

A task holds its depth network, an ``nn.Module`` on its device, the pose
network of the self-supervised losses where ``model.pose_net.name`` names
one, and its model's input, output and loss conventions.  Inputs and
outputs are NHWC, as in the JAX package.  ``train_loss(batch, generator,
progress)`` runs the training forward and then the task's ``losses(batch,
output)``, and returns ``(loss, metrics)``: the network's output dict is
dropped inside, so the graph of an RGBD pass whose outputs no loss of the
task reads is freed before the backward (the completion and DEE tasks read
it, and keep it).  Random draws (the lr-flip and dropout) come from the
caller's ``torch.Generator`` on the task's device.

The pose network stays in eval mode, as in the JAX package, whose
``run_pose`` applies it without ``train`` or ``mutable`` (``:246-253``):
``PoseResNet``'s batch norms normalise with their running statistics in
training too, and those never update; its parameters still train.

``arch.precision: bfloat16`` runs the depth network in bf16, as the JAX
package's ``run_depth`` does (``:183-239``): bf16 casts of its fp32
parameters and float inputs at each call, its outputs back in fp32 before
the flip-back, the upsampling and any loss; the master weights, their
gradients and the running statistics stay fp32.  The pose network is not
cast.

Every depth network, pose network and task of the JAX package's registries
builds here (``DEPTH_NET_REGISTRY``, ``POSE_NET_REGISTRY``, ``:52-65``, and
``TASK_REGISTRY``), the generic ray-surface tasks included.
"""

import torch

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.config.defaults import PRECISIONS, checked
from mindtheedge_tpu_torch.geometry.camera_generic import view_synthesis_generic
from mindtheedge_tpu_torch.geometry.pose import pose_vec2mat
from mindtheedge_tpu_torch.losses.grad_loss import grad_loss
from mindtheedge_tpu_torch.losses.photometric import (
    calc_smoothness, multiview_photometric_loss, ssim)
from mindtheedge_tpu_torch.losses.supervised import supervised_loss
from mindtheedge_tpu_torch.models import packnet, resnet
from mindtheedge_tpu_torch.models.model_utils import upsample_output
from mindtheedge_tpu_torch.models.packnet import PackNet01, PackNetSAN, PackNetSlim01, to_device
from mindtheedge_tpu_torch.models.posenet import PoseNet
from mindtheedge_tpu_torch.models.resnet import DepthResNet, PoseResNet, RaySurfaceResNet
from mindtheedge_tpu_torch.training.checkpoint import restore_depth_net, restore_pose_net
from mindtheedge_tpu_torch.utils.depth import depth2inv, inv2depth
from mindtheedge_tpu_torch.utils.image import flip_lr, match_scales, resize_bilinear
from mindtheedge_tpu_torch.utils.profiling import span

TASK_REGISTRY = {}


def register_task(name):
    def deco(cls):
        TASK_REGISTRY[name] = cls
        return cls
    return deco


def build_task(config, device=None, ckpt=None):
    """The task named by ``config.model.name`` (``tasks.py:43-49``), its
    networks drawn from ``config.arch.seed`` (the pose network from
    ``seed + 1``) and then restored from ``ckpt`` where one is given, on
    ``device`` (``None`` -> CUDA), in eval mode."""
    name = config.model.name
    if name not in TASK_REGISTRY:
        raise KeyError(f'Unknown model {name}; known: {sorted(TASK_REGISTRY)}')
    return TASK_REGISTRY[name](config, device, ckpt)


def build_depth_net(cfg):
    """The depth network of ``config.model.depth_net`` (``tasks.py:68-87``)."""
    channels = tuple(cfg.channels) if cfg.get('channels') else None
    if cfg.name in ('PackNetSAN01', 'PackNetSlimEnc01'):  # ckpt-name bypass
        extra = {'channels': channels} if channels else {}
        return PackNetSAN(version=cfg.version or '1A',
                          input_channels=cfg.input_channels,
                          output_channels=cfg.output_channels,
                          dropout=cfg.dropout or None,
                          remat=cfg.get('remat', False), **extra)
    if cfg.name in ('PackNet01', 'PackNetSlim01'):
        net = PackNet01 if cfg.name == 'PackNet01' else PackNetSlim01
        return net(channels, version=cfg.version or '1A', dropout=cfg.dropout or None)
    if cfg.name in ('DepthResNet', 'RaySurfaceResNet'):
        net = DepthResNet if cfg.name == 'DepthResNet' else RaySurfaceResNet
        return net(version=cfg.version or '18')
    raise ValueError(f'Unknown depth network {cfg.name!r}')


def build_pose_net(cfg):
    """The pose network of ``config.model.pose_net`` (``tasks.py:90-94``)."""
    if cfg.name == 'PoseNet':
        return PoseNet()
    if cfg.name == 'PoseResNet':
        return PoseResNet(version=cfg.version or '18')
    raise ValueError(f'Unknown pose network {cfg.name!r}')


def init_weights(net, seed):
    """Seeded initialisation of a depth or pose network, on the CPU."""
    if isinstance(net, (DepthResNet, PoseResNet)):
        return resnet.init_weights(net, seed)
    return packnet.init_weights(net, seed)


def _maybe_flip(x, flip):
    """``x`` flipped left-right where ``flip`` holds: None (never), True
    (always) or a device boolean, applied without a host sync."""
    if flip is None:
        return x
    if flip is True:
        return flip_lr(x)
    return torch.where(flip, flip_lr(x), x)


def _detached(metrics):
    return {k: v.detach() for k, v in metrics.items()}


class BaseTask:
    """The depth and pose forwards with the lr-flip wrapper, and the loss
    pieces."""

    # batch keys forwarded to the depth net (reference _input_keys)
    input_keys = ('rgb', 'input_depth', 'rgb_edge')
    needs_pose = True
    self_supervised = False     # whether train_loss runs the photometric loss

    def __init__(self, config, device=None, ckpt=None):
        precision = checked('arch.precision', getattr(config.arch, 'precision', 'float32'),
                            PRECISIONS)
        self.compute_dtype = getattr(torch, precision)
        self.config = config
        mloss = config.model.loss
        self.flip_lr_prob = mloss.flip_lr_prob
        self.upsample_depth_maps = mloss.upsample_depth_maps
        self.rotation_mode = mloss.rotation_mode
        self.supervised_method = mloss.supervised_method
        self.supervised_num_scales = mloss.supervised_num_scales
        self.supervised_loss_weight = mloss.supervised_loss_weight
        self.all_scales_edge = mloss.edges_depth_edge_loss_all_scales
        self.depth_edges_loss_weight = mloss.depth_edges_loss_weight
        self.edge_cfg = config.edges
        self.photometric_kwargs = dict(
            num_scales=mloss.num_scales, ssim_loss_weight=mloss.ssim_loss_weight,
            smooth_loss_weight=mloss.smooth_loss_weight, C1=mloss.C1, C2=mloss.C2,
            photometric_reduce_op=mloss.photometric_reduce_op,
            clip_loss=mloss.clip_loss, padding_mode=mloss.padding_mode,
            automask_loss=mloss.automask_loss)
        device = resolve_device(device)
        net = init_weights(build_depth_net(config.model.depth_net), config.arch.seed)
        if ckpt is not None:
            restore_depth_net(net, ckpt)
        self.depth_net = to_device(net, device)
        self.pose_net = None
        if self.needs_pose and config.model.pose_net.name:
            pose = init_weights(build_pose_net(config.model.pose_net), config.arch.seed + 1)
            if ckpt is not None:
                restore_pose_net(pose, ckpt)
            self.pose_net = to_device(pose, device)
        self.device = device
        # the seams of the spatially sharded step (parallel/spatial.py,
        # tasks.py:143-155): ``net_input_transform(rgb, lidar, rgb_edge)`` ->
        # the network's inputs, ``output_hook(out)`` -> the output the
        # losses read; None leaves both as they are
        self.net_input_transform = None
        self.output_hook = None

    @property
    def takes_rgb_edge(self):
        """Whether the depth network reads ``batch['rgb_edge']``: a
        4-channel PackNet-SAN, in a task whose ``input_keys`` hold it."""
        return getattr(self.depth_net, 'input_channels', 3) == 4 \
            and 'rgb_edge' in self.input_keys

    def run_depth(self, batch, force_flip=False, train=False, generator=None):
        """Depth net with the lr-flip wrapper (``tasks.py:180-244``).

        ``batch['rgb']`` [B,H,W,3] and, if present, ``batch['input_depth']``
        [B,H,W,1] -> the network's output dict, NHWC; a 4-channel network
        also reads ``batch['rgb_edge']`` [B,H,W,1].  The network is put
        into ``train`` mode here.  At eval (no autograd) ``force_flip`` runs
        it on the lr-flipped inputs and flips its outputs back.  In
        training, one Bernoulli(``flip_lr_prob``) draw from ``generator``
        flips the whole batch, on the device; at ``flip_lr_prob`` 0 nothing
        is drawn.  Only the inverse depths are flipped back: a ray surface
        comes back as the network computed it, on the flipped input and in
        ``compute_dtype``, as in the JAX package (``:231-239``).
        ``upsample_depth_maps`` then brings every training scale to full
        resolution.  The network computes in ``compute_dtype``
        (:meth:`_depth_forward`); the inverse depths and ``depth_loss`` come
        back fp32.  ``net_input_transform`` sees the inputs after the flip, and
        ``output_hook`` the network's outputs before the flip-back: the
        spatial step slices the frame and gathers the pyramid there.
        """
        self.depth_net.train(train)
        flip = None
        if train and self.flip_lr_prob > 0:
            flip = torch.rand((), device=self.device,
                              generator=generator) < self.flip_lr_prob
        elif not train and force_flip:
            flip = True
        inputs = [batch['rgb'], batch.get('input_depth'),
                  batch.get('rgb_edge') if self.takes_rgb_edge else None]
        inputs = [None if x is None else _maybe_flip(x, flip) for x in inputs]
        if self.net_input_transform is not None:
            inputs = self.net_input_transform(*inputs)
        with torch.set_grad_enabled(train):
            out = self._depth_forward(*inputs, generator)
            if self.output_hook is not None:
                out = self.output_hook(out)
            for key in ('inv_depths', 'inv_depths_rgbd'):
                if key in out:
                    out[key] = [_maybe_flip(d.float(), flip) for d in out[key]]
            if 'depth_loss' in out:
                out['depth_loss'] = out['depth_loss'].float()
            if train and self.upsample_depth_maps:
                out = upsample_output(out)
        return out

    def _depth_forward(self, rgb, lidar, rgb_edge, generator):
        """The depth network in ``compute_dtype``.  Below fp32 it runs on
        casts of its fp32 parameters (``torch.func.functional_call``), so
        gradients flow back through the casts to the masters in fp32, and
        on casts of the float inputs; its running statistics stay the
        module's fp32 buffers (``ops.sparse.MaskedBatchNorm``)."""
        net, dtype = self.depth_net, self.compute_dtype
        if dtype == torch.float32:
            return net(rgb, lidar, generator, rgb_edge)
        cast = lambda t: t.to(dtype) if t is not None and t.dtype == torch.float32 else t
        params = {n: p.to(dtype) for n, p in net.named_parameters()}
        return torch.func.functional_call(
            net, params, (cast(rgb), cast(lidar), generator, cast(rgb_edge)))

    def run_pose(self, batch):
        """The pose network on ``batch['rgb']`` and ``batch['rgb_context']``
        -> one [B,4,4] transform per context image (``tasks.py:246-253``),
        the network in eval mode (see the module's docstring).  A call is
        the span ``mte.net.pose``."""
        with span('mte.net.pose'):
            pose_vec = self.pose_net.eval()(batch['rgb'], batch['rgb_context'])
            return [pose_vec2mat(pose_vec[:, i], self.rotation_mode)
                    for i in range(pose_vec.shape[1])]

    def infer(self, batch, force_flip=False):
        return self.run_depth(batch, force_flip=force_flip)

    # -- loss pieces -----------------------------------------------------------
    def check_trainable(self):
        """Raise for a configuration ``train_loss`` cannot run, before any
        work: the photometric loss needs a pose network."""
        if self.self_supervised and self.pose_net is None:
            raise ValueError(
                f'{type(self).__name__} with supervised_loss_weight '
                f'{self.supervised_loss_weight} runs the photometric loss, which '
                'needs model.pose_net.name (PoseNet or PoseResNet) and context '
                'frames (datasets.train.back_context / forward_context)')

    def _self_sup_loss(self, batch, output, poses):
        """The photometric loss of the target image against its context
        images (``tasks.py:262-268``), as the span ``mte.train.photometric``."""
        with span('mte.train.photometric'):
            return multiview_photometric_loss(
                batch['rgb_original'], batch['rgb_context_original'],
                output['inv_depths'], batch['intrinsics'], batch['intrinsics'],
                poses, **self.photometric_kwargs)

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

    def _zero(self):
        return torch.zeros((), device=self.device)

    def prep_batch(self, batch):
        """The batch as the network reads it (the identity but for DEE)."""
        return batch

    def train_loss(self, batch, generator=None, progress=0.0):
        """The training forward, then :meth:`losses` -> (loss, metrics);
        the output dict dies here, before the caller's backward."""
        batch = self.prep_batch(batch)
        return self.losses(batch, self.run_depth(batch, train=True, generator=generator))


@register_task('SfmModel')
class SfmTask(BaseTask):
    """Depth (+ pose) container with no loss of its own (``tasks.py:306-313``):
    the step updates only the depth network's running statistics."""

    def losses(self, batch, out):
        zero = self._zero()
        return zero, {'loss': zero}


@register_task('SelfSupModel')
class SelfSupTask(BaseTask):
    """The multiview photometric loss (``tasks.py:316-324``, reference
    ``SelfSupModel.py:64-98``)."""

    self_supervised = True

    def losses(self, batch, out):
        loss, metrics = self._self_sup_loss(batch, out, self.run_pose(batch))
        return loss, _detached(dict(metrics, loss=loss))


@register_task('SemiSupModel')
class SemiSupTask(SelfSupTask):
    """(1-w) * selfsup + w * supervised (``tasks.py:327-348``).  At w = 1 no
    pose network is built."""

    def __init__(self, config, device=None, ckpt=None):
        self.self_supervised = self.needs_pose = \
            config.model.loss.supervised_loss_weight != 1.0
        super().__init__(config, device, ckpt)

    def _weighted_self_sup(self, batch, out):
        """(1 - w) * the photometric loss and its metrics; 0 and none at
        w = 1 (``tasks.py:339-344``)."""
        if not self.self_supervised:
            return self._zero(), {}
        loss, metrics = self._self_sup_loss(batch, out, self.run_pose(batch))
        return (1.0 - self.supervised_loss_weight) * loss, metrics

    def losses(self, batch, out):
        loss, metrics = self._weighted_self_sup(batch, out)
        sup = self._supervised(out['inv_depths'], batch['depth'])
        loss = loss + self.supervised_loss_weight * sup
        return loss, _detached(dict(metrics, supervised_loss=sup, loss=loss))


@register_task('SemiSupCompletionModel')
class SemiSupCompletionTask(SemiSupTask):
    """+ the depth-completion (RGBD) pass's supervised loss and the
    feature-consistency ``depth_loss`` (``tasks.py:351-380``, reference
    ``SemiSupCompletionModel.py:76-124``).  Its loss reads the RGBD pass, so
    that pass's graph lives through the backward."""

    weight_rgbd = 1.0

    def losses(self, batch, out):
        loss, metrics = self._weighted_self_sup(batch, out)
        sup = self._supervised(out['inv_depths'], batch['depth'])
        loss = loss + self.supervised_loss_weight * sup
        if 'inv_depths_rgbd' in out:
            sup2 = self._supervised(out['inv_depths_rgbd'], batch['depth'])
            loss = loss + self.weight_rgbd * self.supervised_loss_weight * sup2
            metrics['supervised_loss_rgbd'] = sup2
            if 'depth_loss' in out:
                loss = loss + out['depth_loss']
                metrics['depth_loss'] = out['depth_loss']
        return loss, _detached(dict(metrics, supervised_loss=sup, loss=loss))


@register_task('SemiSupEdgeModel')
class SemiSupEdgeTask(SemiSupTask):
    """The paper's training model (``tasks.py:382-419``, reference
    ``SemiSupEdgeModel.py:98-162``): (1-w) * selfsup + w * supervised +
    edge_w * GradLoss over the scales.  The edge term is gated on
    ``edges.train_depth_edges``; off, it reports 0."""

    def _edge(self, inv_depths, batch):
        if not self.edge_cfg.train_depth_edges:
            return self._zero()
        return self._edge_loss_all_scales(
            inv_depths, batch, batch.get('rgb_edge'),
            is_grad=True, is_sigmoid=True, sigmoid_thresh=4.0)

    def train_loss(self, batch, generator=None, progress=0.0):
        """Refuses, before any work, the edge loss at all scales with an
        ``rgb_edge`` mask: the mask is full size and the maps of scales 1-3
        are not (ROADMAP "Kept on purpose"; the JAX package stops inside
        the loss there, with a TypeError)."""
        if self.all_scales_edge and self.edge_cfg.train_depth_edges \
                and batch.get('rgb_edge') is not None:
            raise ValueError(
                'model.loss.edges_depth_edge_loss_all_scales takes the edge loss at '
                'scales 1-3, whose maps are smaller than the batch\'s full-size rgb_edge '
                'mask: set it False, or train on a split without an rgb_edge column')
        return super().train_loss(batch, generator, progress)

    def losses(self, batch, out):
        loss, metrics = self._weighted_self_sup(batch, out)
        edge = self.depth_edges_loss_weight * self._edge(out['inv_depths'], batch)
        supervised = self.supervised_loss_weight * self._supervised(
            out['inv_depths'], batch['depth'])
        loss = loss + supervised + edge
        return loss, _detached(dict(metrics, edge_loss=edge,
                                    supervised_loss=supervised, loss=loss))


@register_task('SemiSupEdgeCompletionModel')
class SemiSupEdgeCompletionTask(SemiSupEdgeTask):
    """Edge + completion (``tasks.py:422-468``, reference
    ``SemiSupEdgeCompletionModel.py:96-180``): the supervised and edge terms
    of both passes, halved, and ``depth_loss``.  As in the JAX package,
    ``edge_lidar_loss`` is 0 without an RGBD pass, where the reference's is
    undefined (``tasks.py:452``)."""

    weight_rgbd = 1.0

    def losses(self, batch, out):
        loss, metrics = self._weighted_self_sup(batch, out)
        edge = self.depth_edges_loss_weight * self._edge(out['inv_depths'], batch)
        supervised = self.supervised_loss_weight * self._supervised(
            out['inv_depths'], batch['depth']) / 2.0
        edge_lidar = self._zero()
        if 'inv_depths_rgbd' in out:
            edge_lidar = self._edge(out['inv_depths_rgbd'], batch)
            sup2 = self._supervised(out['inv_depths_rgbd'], batch['depth'])
            supervised = supervised + \
                self.weight_rgbd * self.supervised_loss_weight * sup2 / 2.0
            if 'depth_loss' in out:
                loss = loss + out['depth_loss']
                metrics['depth_loss'] = out['depth_loss']
        loss = loss + supervised + (edge + edge_lidar) / 2.0
        return loss, _detached(dict(metrics, edge_loss=edge, edge_lidar_loss=edge_lidar,
                                    supervised_loss=supervised, loss=loss))


@register_task('EdgeEstimationLIDARModel')
class EdgeEstimationLIDARTask(BaseTask):
    """The DEE model (``tasks.py:471-535``, reference
    ``EdgeEstimationLIDARModel.py:87-181``): the LiDAR divided by 200, the
    predictions halved into a [0, 1] edge probability, the edge BCE
    (GradLoss with ``is_grad`` and ``is_sigmoid`` off) on the RGB and RGBD
    passes.  ``infer`` divides and halves every scale; ``run_depth`` does
    neither: the annotation CLI divides the LiDAR itself when it reads it
    and halves each scale it uses."""

    needs_pose = False
    input_keys = ('rgb', 'input_depth')
    weight_rgbd = 1.0

    def prep_batch(self, batch):
        batch = dict(batch)
        if batch.get('input_depth') is not None:
            batch['input_depth'] = batch['input_depth'] / 200.0
        return batch

    def infer(self, batch, force_flip=False):
        out = self.run_depth(self.prep_batch(batch), force_flip=force_flip)
        out['inv_depths'] = [d / 2.0 for d in out['inv_depths']]
        return out

    def losses(self, batch, out):
        # the first 4 scales halved with all-scale edges, scale 0 alone
        # otherwise (tasks.py:492-500)
        n = 4 if self.all_scales_edge else 1
        for key in ('inv_depths', 'inv_depths_rgbd'):
            if key in out:
                out[key] = [d / 2.0 if s < n else d for s, d in enumerate(out[key])]

        def edge(probs):
            return self._edge_loss_all_scales(
                probs, batch, None, is_grad=False, is_sigmoid=False,
                use_normals=False, convert_to_depth=False)

        edge_rgb = edge(out['inv_depths'])
        metrics = {'edge_loss': edge_rgb}
        loss, edge_lidar = self._zero(), self._zero()
        if 'inv_depths_rgbd' in out:
            edge_lidar = edge(out['inv_depths_rgbd'])
            metrics['edge_lidar_loss'] = edge_lidar
            if 'depth_loss' in out:
                loss = loss + out['depth_loss']
                metrics['depth_loss'] = out['depth_loss']
        loss = loss + (edge_rgb + self.weight_rgbd * edge_lidar) / 2.0
        return loss, _detached(dict(metrics, loss=loss))


@register_task('VelSupModel')
class VelSupTask(SelfSupTask):
    """SelfSup + velocity supervision, the norm of the predicted pose's
    translation against the GT pose's (``tasks.py:537-558``, reference
    ``VelSupModel.py:19-53``, ``losses/velocity_loss.py:30-38``).  The JAX
    step runs the pose network twice, once per term, and XLA merges the
    two; here the poses are computed once and feed both."""

    def __init__(self, config, device=None, ckpt=None):
        super().__init__(config, device, ckpt)
        self.velocity_loss_weight = config.model.loss.velocity_loss_weight

    def losses(self, batch, out):
        poses = self.run_pose(batch)
        loss, metrics = self._self_sup_loss(batch, out, poses)
        vel = self._zero()
        for pred, gt in zip(poses, batch['pose_context']):
            vel = vel + (pred[:, :3, 3].norm(dim=-1) - gt[:, :3, 3].norm(dim=-1)).abs().mean()
        vel = vel / max(len(poses), 1)
        loss = loss + self.velocity_loss_weight * vel
        return loss, _detached(dict(metrics, velocity_loss=vel, loss=loss))


@register_task('GenericSfmModel')
class GenericSfmTask(SfmTask):
    """The ray-surface depth (+ pose) container (``tasks.py:561-572``,
    reference ``models/GenericSfmModel.py``): no loss of its own; the depth
    network (``RaySurfaceResNet``) returns a per-pixel ray surface beside the
    inverse depths, and inference passes it through."""


@register_task('GenericSelfSupModel')
class GenericSelfSupTask(GenericSfmTask):
    """Ray-surface self-supervision (``tasks.py:575-634``, reference
    ``models/GenericSelfSupModel.py``,
    ``losses/generic_multiview_photometric_loss.py``): each context image is
    warped into the target at each of ``num_scales`` scales through the
    network's ray surface (``geometry/camera_generic.view_synthesis_generic``,
    patch radius ``min(20, max(2, h // 8))``, temperature annealed by
    ``progress``), the photometric error (SSIM and L1, or L1 alone at SSIM
    weight 0) reduced over the contexts (and the unwarped contexts with
    ``automask_loss``) by ``photometric_reduce_op`` ('mean' or 'min'), plus
    the edge-aware smoothness."""

    self_supervised = True

    def train_loss(self, batch, generator=None, progress=0.0):
        return self.losses(batch, self.run_depth(batch, train=True, generator=generator),
                           progress)

    def _photo(self, warped, image):
        """The photometric error map (``tasks.py:594-600``)."""
        pk = self.photometric_kwargs
        l1 = (warped - image).abs()
        w = pk['ssim_loss_weight']
        if w <= 0:
            return l1
        s = torch.clamp((1.0 - ssim(warped, image, pk['C1'], pk['C2'])) / 2.0, 0, 1)
        return w * s.mean(-1, keepdim=True) + (1 - w) * l1.mean(-1, keepdim=True)

    def losses(self, batch, out, progress=0.0):
        pk = self.photometric_kwargs
        n = pk['num_scales']
        poses = self.run_pose(batch)
        ray_surface, inv_depths = out['ray_surface'], out['inv_depths']
        images = match_scales(batch['rgb_original'], inv_depths, n)
        per_scale = [[] for _ in range(n)]
        for ref_image, pose in zip(batch['rgb_context_original'], poses):
            ref_images = match_scales(ref_image, inv_depths, n)
            for i in range(n):
                h, w = inv_depths[i].shape[1:3]
                rs = ray_surface if ray_surface.shape[1] == h else \
                    resize_bilinear(ray_surface, (h, w), align_corners=True)
                warped = view_synthesis_generic(
                    ref_images[i], inv2depth(inv_depths[i]), rs, rs, pose,
                    progress=progress, padding_mode=pk['padding_mode'],
                    patch_radius=min(20, max(2, h // 8)))
                per_scale[i].append(self._photo(warped, images[i]))
                if pk['automask_loss']:
                    per_scale[i].append(self._photo(ref_images[i], images[i]))

        def reduce(losses):
            if pk['photometric_reduce_op'] == 'mean':
                return sum(l.mean() for l in losses) / len(losses)
            return torch.cat(losses, -1).min(-1).values.mean()

        loss = sum(reduce(per_scale[i]) for i in range(n)) / n
        metrics = {'photometric_loss': loss}
        if pk['smooth_loss_weight'] > 0:
            sx, sy = calc_smoothness(inv_depths, images, n)
            smooth = sum((sx[i].abs().mean() + sy[i].abs().mean()) / 2 ** i
                         for i in range(n)) / n
            smooth = pk['smooth_loss_weight'] * smooth
            loss = loss + smooth
            metrics['smoothness_loss'] = smooth
        return loss, _detached(dict(metrics, loss=loss))
