"""Task models at eval: counterpart of ``mindtheedge_tpu/models/tasks.py``
(``TASK_REGISTRY``, ``build_task``, ``build_depth_net`` ``:33-88``;
``BaseTask.run_depth`` / ``infer`` ``:180-259``; ``SemiSupEdgeTask``;
``EdgeEstimationLIDARTask`` ``:471-511``).

A task holds its depth network, an ``nn.Module`` in eval mode on its device,
and its model's input and output conventions.  Inputs and outputs are NHWC,
as in the JAX package.  Training (``train_loss``, the pose network, the
other tasks) waits for ROADMAP Slice C; bf16 compute for item 9.
"""

import torch

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.models.packnet import PackNetSAN, init_weights, to_device
from mindtheedge_tpu_torch.training.checkpoint import restore_depth_net

TASK_REGISTRY = {}


def register_task(name):
    def deco(cls):
        TASK_REGISTRY[name] = cls
        return cls
    return deco


def build_task(config, device=None, ckpt=None):
    """The task named by ``config.model.name`` (``tasks.py:43-49``), its
    network drawn from ``config.arch.seed`` and then restored from ``ckpt``
    where one is given, on ``device`` (``None`` -> CUDA)."""
    name = config.model.name
    if name not in TASK_REGISTRY:
        raise KeyError(f'Unknown model {name}; the port has '
                       f'{sorted(TASK_REGISTRY)} (the other tasks wait for '
                       'ROADMAP Slice C)')
    return TASK_REGISTRY[name](config, device, ckpt)


def build_depth_net(cfg):
    """The depth network of ``config.model.depth_net`` (``tasks.py:68-87``)."""
    if cfg.name in ('PackNetSAN01', 'PackNetSlimEnc01'):  # ckpt-name bypass
        extra = {'channels': tuple(cfg.channels)} if cfg.get('channels') else {}
        return PackNetSAN(version=cfg.version or '1A',
                          input_channels=cfg.input_channels,
                          output_channels=cfg.output_channels, **extra)
    if cfg.name in ('PackNet01', 'PackNetSlim01'):
        raise NotImplementedError(
            f'{cfg.name} waits for ROADMAP Queue 1 item 10')
    raise NotImplementedError(
        f'depth network {cfg.name!r} is not ported (ROADMAP Slice C)')


def _flip_lr(x):
    """Horizontal flip of [B,H,W,C] (``utils/image.flip_lr``)."""
    return torch.flip(x, dims=(2,))


class BaseTask:
    """The eval-time depth forward with its optional lr-flip wrapper."""

    # batch keys forwarded to the depth net (reference _input_keys)
    input_keys = ('rgb', 'input_depth', 'rgb_edge')

    def __init__(self, config, device=None, ckpt=None):
        if getattr(config.arch, 'precision', 'float32') == 'bfloat16':
            raise NotImplementedError(
                'arch.precision bfloat16 waits for ROADMAP Queue 1 item 9')
        self.config = config
        device = resolve_device(device)
        net = init_weights(build_depth_net(config.model.depth_net),
                           config.arch.seed)
        if ckpt is not None:
            restore_depth_net(net, ckpt)
        self.depth_net = to_device(net, device)
        self.device = device

    @torch.no_grad()
    def run_depth(self, batch, force_flip=False):
        """Depth net at eval (``tasks.py:180-244``): ``batch['rgb']``
        [B,H,W,3] and, if present, ``batch['input_depth']`` [B,H,W,1] ->
        ``{'inv_depths': [4 x [B,h,w,1]]}``.  ``force_flip`` runs the
        network on the lr-flipped inputs and flips its outputs back.  The
        4-channel ``rgb_edge`` input is not ported (the network raises at
        build for ``input_channels == 4``), so ``rgb_edge`` is unused."""
        rgb = batch['rgb']
        lidar = batch.get('input_depth')
        if force_flip:
            rgb = _flip_lr(rgb)
            lidar = None if lidar is None else _flip_lr(lidar)
        out = self.depth_net(rgb, lidar)
        if force_flip:
            out['inv_depths'] = [_flip_lr(d) for d in out['inv_depths']]
        return out

    def infer(self, batch, force_flip=False):
        return self.run_depth(batch, force_flip=force_flip)

    def train_loss(self, *args, **kwargs):
        raise NotImplementedError('training waits for ROADMAP Slice C')


@register_task('SemiSupEdgeModel')
class SemiSupEdgeTask(BaseTask):
    """The paper's model (``tasks.py:382-419``); at eval the base forward."""


@register_task('EdgeEstimationLIDARModel')
class EdgeEstimationLIDARTask(BaseTask):
    """The DEE model (``tasks.py:471-511``): ``infer`` divides the LiDAR by
    200 and halves every scale into a [0, 1] edge probability.
    ``run_depth`` does neither: the annotation CLI divides the LiDAR itself
    when it reads it and halves each scale it uses."""

    input_keys = ('rgb', 'input_depth')

    def infer(self, batch, force_flip=False):
        batch = dict(batch)
        if batch.get('input_depth') is not None:
            batch['input_depth'] = batch['input_depth'] / 200.0
        out = self.run_depth(batch, force_flip=force_flip)
        out['inv_depths'] = [d / 2.0 for d in out['inv_depths']]
        return out
