"""PackNet depth networks: counterpart of
``mindtheedge_tpu/models/packnet.py`` (reference ``PackNetSAN01.py``,
``PackNet01.py``, ``PackNetSlim01.py``).

[B,C,H,W] inside, NCHW or channels-last by ``ops/blocks.nhwc``; each
network's ``forward`` takes and returns NHWC like the JAX modules.  The
``state_dict`` keys are the reference PackNetSAN01 names.
"""

import math

import torch
import torch.nn as nn

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.config.defaults import REMAT_MODES, checked
from mindtheedge_tpu_torch.ops import remat
from mindtheedge_tpu_torch.ops.blocks import (
    ConvBlock, InvDepthHead, PackLayerConv3d, ResidualBlock, UnpackLayerConv3d, lay_out_weights)
from mindtheedge_tpu_torch.ops.packing import channels_last, upsample_nearest2x
from mindtheedge_tpu_torch.ops.sparse import MinkConv, SparseDepthEncoder
from mindtheedge_tpu_torch.utils.profiling import span

# Encoder/decoder widths (PackNetSAN01.py:179-184)
SLIM_CHANNELS = (32, 32, 64, 128, 256, 512)     # PackNetSlim / PackNetSAN
FULL_CHANNELS = (64, 64, 64, 128, 256, 512)     # PackNet01 (PackNet01.py:34-35)
NUM_BLOCKS = (2, 2, 3, 3)
PACK_KERNEL = (5, 3, 3, 3, 3)
UNPACK_KERNEL = (3, 3, 3, 3, 3)
ICONV_KERNEL = (3, 3, 3, 3, 3)
NUM_3D_FEAT = 4


class PackNetSlimEncoder(nn.Module):
    """Reference ``PackNetSlimEnc01``; returns (x5p, [skip1, x1p..x4p])."""

    def __init__(self, channels=SLIM_CHANNELS, in_channels=3, dropout=None):
        super().__init__()
        ni, n1, n2, n3, n4, n5 = channels
        d = NUM_3D_FEAT
        self.pre_calc = ConvBlock(in_channels, ni, 5)
        self.conv1 = ConvBlock(ni, n1, 7)
        self.pack1 = PackLayerConv3d(n1, PACK_KERNEL[0], d=d)
        self.conv2 = ResidualBlock(n1, n2, NUM_BLOCKS[0], dropout=dropout)
        self.pack2 = PackLayerConv3d(n2, PACK_KERNEL[1], d=d)
        self.conv3 = ResidualBlock(n2, n3, NUM_BLOCKS[1], dropout=dropout)
        self.pack3 = PackLayerConv3d(n3, PACK_KERNEL[2], d=d)
        self.conv4 = ResidualBlock(n3, n4, NUM_BLOCKS[2], dropout=dropout)
        self.pack4 = PackLayerConv3d(n4, PACK_KERNEL[3], d=d)
        self.conv5 = ResidualBlock(n4, n5, NUM_BLOCKS[3], dropout=dropout)
        self.pack5 = PackLayerConv3d(n5, PACK_KERNEL[4], d=d)

    # (index, count): this rank's chunk of a batch sharded over ``count``
    # ranks (parallel/mesh.make_sharded_train_step); None: the whole batch
    batch_shard = None

    def dropout_keeps(self, batch, device, generator=None):
        """The dropout masks of one training forward (one list per residual
        stack), drawn from ``generator`` in the order the forward runs the
        blocks; None without dropout.  Under ``batch_shard`` (i, n) they are
        drawn for the global batch of ``n * batch`` and the i-th chunk's
        kept, so every rank draws what the unsharded forward draws."""
        stacks = (self.conv2, self.conv3, self.conv4, self.conv5)
        if not stacks[0][0].dropout:
            return None
        if self.batch_shard is None:
            return [s.dropout_keeps(batch, device, generator) for s in stacks]
        i, n = self.batch_shard
        return [[k.chunk(n)[i] for k in s.dropout_keeps(n * batch, device, generator)]
                for s in stacks]

    def forward(self, rgb, keeps=None):
        keeps = keeps or (None,) * 4
        x = self.pre_calc(rgb)
        x1p = self.pack1(self.conv1(x))
        x2p = self.pack2(self.conv2(x1p, keeps[0]))
        x3p = self.pack3(self.conv3(x2p, keeps[1]))
        x4p = self.pack4(self.conv4(x3p, keeps[2]))
        x5p = self.pack5(self.conv5(x4p, keeps[3]))
        return x5p, [x, x1p, x2p, x3p, x4p]


def decoder_version(version):
    """The decoder's letter of a network version, by the JAX package's rule
    (``packnet.py:223, 289``): '1A' -> 'A', '1B' -> 'B', '1' -> 'A'."""
    return version[1:] or 'A'


class PackNetDecoder(nn.Module):
    """Reference ``Decoder`` (``packnet.py:94-178``); returns the inverse
    depths at strides 1, 2, 4, 8.  Version ``'A'`` concatenates each unpack
    layer's output with its skip; any other letter adds them
    (``:114-115``), so each skip must have its unpack layer's width: the
    widths ``channels`` must all be equal.  The JAX package's version B
    fails at its first forward otherwise (an add that cannot broadcast);
    here the network refuses at construction.  (The reference's version B
    narrows its unpack layers to the skip widths instead; the port follows
    the JAX package, its reference.)"""

    def __init__(self, channels=SLIM_CHANNELS, out_channels=1, version='A'):
        super().__init__()
        ni, n1, n2, n3, n4, n5 = channels
        d, o = NUM_3D_FEAT, out_channels
        self.concat = version == 'A'
        if not self.concat and len(set(channels)) > 1:
            raise ValueError(
                f'PackNet decoder version {version!r} adds each skip to its unpack '
                f'layer\'s output, so every width must be equal; channels {tuple(channels)} '
                'give unpack widths (n5, n4, n3, n2, n1) against skip widths '
                '(n4, n3, n2, n1, ni)')
        skip = lambda n_unpack, n_skip: n_unpack + (n_skip if self.concat else 0)
        self.unpack5 = UnpackLayerConv3d(n5, n5, UNPACK_KERNEL[0], d=d)
        self.unpack4 = UnpackLayerConv3d(n5, n4, UNPACK_KERNEL[1], d=d)
        self.unpack3 = UnpackLayerConv3d(n4, n3, UNPACK_KERNEL[2], d=d)
        self.unpack2 = UnpackLayerConv3d(n3, n2, UNPACK_KERNEL[3], d=d)
        self.unpack1 = UnpackLayerConv3d(n2, n1, UNPACK_KERNEL[4], d=d)
        self.iconv5 = ConvBlock(skip(n5, n4), n5, ICONV_KERNEL[0])
        self.iconv4 = ConvBlock(skip(n4, n3), n4, ICONV_KERNEL[1])
        self.iconv3 = ConvBlock(skip(n3, n2) + o, n3, ICONV_KERNEL[2])
        self.iconv2 = ConvBlock(skip(n2, n1) + o, n2, ICONV_KERNEL[3])
        self.iconv1 = ConvBlock(skip(n1, ni) + o, n1, ICONV_KERNEL[4])
        self.disp4_layer = InvDepthHead(n4, o)
        self.disp3_layer = InvDepthHead(n3, o)
        self.disp2_layer = InvDepthHead(n2, o)
        self.disp1_layer = InvDepthHead(n1, o)

    def _join(self, unpacked, skip, *rest):
        """The iconv's input: [unpacked, skip] (A) or [unpacked + skip]
        (B), then ``rest``, on channels, in ``unpacked``'s layout: a
        channels-last join concatenates the NHWC views, since ``torch.cat``
        of a 1-channel map whose strides read NCHW would return NCHW."""
        parts = ([unpacked, skip] if self.concat else [unpacked + skip]) + list(rest)
        if channels_last(unpacked):
            return torch.cat([p.permute(0, 2, 3, 1) for p in parts], -1).permute(0, 3, 1, 2)
        return torch.cat(parts, 1)

    def forward(self, x5p, skips):
        skip1, skip2, skip3, skip4, skip5 = skips
        iconv5 = self.iconv5(self._join(self.unpack5(x5p), skip5))
        iconv4 = self.iconv4(self._join(self.unpack4(iconv5), skip4))
        inv_depth4 = self.disp4_layer(iconv4)
        iconv3 = self.iconv3(self._join(
            self.unpack3(iconv4), skip3, upsample_nearest2x(inv_depth4)))
        inv_depth3 = self.disp3_layer(iconv3)
        iconv2 = self.iconv2(self._join(
            self.unpack2(iconv3), skip2, upsample_nearest2x(inv_depth3)))
        inv_depth2 = self.disp2_layer(iconv2)
        iconv1 = self.iconv1(self._join(
            self.unpack1(iconv2), skip1, upsample_nearest2x(inv_depth2)))
        inv_depth1 = self.disp1_layer(iconv1)
        return [inv_depth1, inv_depth2, inv_depth3, inv_depth4]


def _nchw(t):
    return None if t is None else t.permute(0, 3, 1, 2)


def _nhwc(ts):
    return [t.permute(0, 2, 3, 1) for t in ts]


class PackNetSAN(nn.Module):
    """PackNet-SAN (``packnet.py:181-272``).

    ``forward(rgb [B,H,W,3], input_depth [B,H,W,1] or None, generator,
    rgb_edge [B,H,W,1] or None)``, NHWC in and out:

    * eval: one pass -> ``{'inv_depths': [4 x [B,h,w,1]]}``.  With LiDAR,
      each skip level is fused as ``skip * weight[i] + san[i] + bias[i]``
      (``:234-243``).
    * training without LiDAR: the RGB pass -> ``{'inv_depths'}``.
    * training with LiDAR: the RGB pass, then the RGBD pass ->
      ``{'inv_depths', 'inv_depths_rgbd', 'depth_loss'}``, where
      ``depth_loss`` is the mean over the 6 skip levels of the mean squared
      difference between the passes' features, the RGBD side detached.  The
      RGBD pass is the only one that runs the SAN ladder, so it is the one
      that updates its running statistics, once per step.

    ``input_channels`` 4 takes ``rgb_edge`` as the encoder's 4th input
    channel in every pass, and at eval multiplies ``inv_depths[0]`` by it
    (``:245-255``); 3 ignores ``rgb_edge``.  ``version`` '1A' concatenates
    the decoder's skips, '1B' adds them (:class:`PackNetDecoder`, which
    raises where the widths cannot add).

    ``generator`` feeds the encoder's dropout draws in training: each pass
    draws its masks before it runs the encoder, in the order the blocks
    use them.  ``remat`` (True or ``'conv'``, ``ops/remat.py``) recomputes
    the encoder, the SAN ladder and the decoder in the backward of a
    training pass, as the JAX package's ``nn.remat`` does (``'conv'`` keeps
    every conv's output); the loss, the gradients, the running statistics
    and the generator's state are those of the pass without it.  The
    config's ``freeze_*`` flags are the optimizer's: it leaves those
    parameters out (``training/optimizer.py``), as the JAX package does.

    The module computes in the dtype of its parameters and inputs: bf16
    where ``tasks.BaseTask.run_depth`` hands it bf16 casts of its fp32
    parameters, or where :func:`to_device` casts it once for serving.
    A call is the span ``mte.net.forward`` (``utils/profiling.py``).
    """

    def __init__(self, channels=SLIM_CHANNELS, version='1A', input_channels=3,
                 output_channels=1, dropout=None, remat=False):
        super().__init__()
        if input_channels not in (3, 4):
            raise ValueError(f'PackNetSAN takes 3 (rgb) or 4 (rgb + rgb_edge) input '
                             f'channels, not {input_channels}')
        self.input_channels = input_channels
        self.remat = checked('model.depth_net.remat', remat, REMAT_MODES)
        self.encoder = PackNetSlimEncoder(channels, input_channels, dropout)
        self.decoder = PackNetDecoder(channels, output_channels, decoder_version(version))
        self.mconvs = SparseDepthEncoder(tuple(channels[1:]))
        self.weight = nn.Parameter(torch.ones(5))
        self.bias = nn.Parameter(torch.zeros(5))

    def _region(self, module, *args):
        """``module(*args)``; under ``remat`` in a training pass with
        autograd on, recomputed in the backward.  The recompute runs after
        ``tasks.BaseTask.run_depth``'s ``functional_call`` has put the fp32
        masters back, so it is handed the tensors this pass used."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return module(*args)
        params = dict(module.named_parameters())
        return remat.checkpoint(
            lambda p, *a: torch.func.functional_call(module, p, a),
            params, *args, policy=self.remat)

    def run_network(self, rgb, input_depth=None, generator=None):
        """NCHW: rgb [B,C,H,W] (C = ``input_channels``), input_depth
        [B,1,H,W] -> (4 inverse depths, the 6 fused skip features)."""
        keeps = (self.encoder.dropout_keeps(rgb.shape[0], rgb.device, generator)
                 if self.training else None)
        x5p, skips = self._region(self.encoder, rgb, keeps)
        if input_depth is not None:
            san = self._region(self.mconvs, input_depth)
            w, b = self.weight, self.bias
            for i in range(4):
                skips[i + 1] = skips[i + 1] * w[i] + san[i] + b[i]
            x5p = x5p * w[4] + san[4] + b[4]
        return self._region(self.decoder, x5p, skips), skips + [x5p]

    def forward(self, rgb, input_depth=None, generator=None, rgb_edge=None):
        with span('mte.net.forward'):
            if self.input_channels == 4:
                if rgb_edge is None:
                    raise ValueError('PackNetSAN with input_channels 4 needs rgb_edge [B,H,W,1]')
                rgb = torch.cat([rgb, rgb_edge], -1)
            rgb, lidar = _nchw(rgb), _nchw(input_depth)
            if not self.training:
                inv_depths = _nhwc(self.run_network(rgb, lidar)[0])
                if self.input_channels == 4:
                    inv_depths[0] = inv_depths[0] * rgb_edge
                return {'inv_depths': inv_depths}
            inv_rgb, feat_rgb = self.run_network(rgb, None, generator)
            out = {'inv_depths': _nhwc(inv_rgb)}
            if lidar is None:
                return out
            inv_rgbd, feat_rgbd = self.run_network(rgb, lidar, generator)
            out['inv_depths_rgbd'] = _nhwc(inv_rgbd)
            out['depth_loss'] = sum(
                torch.mean((d.detach().float() - r.float()) ** 2)
                for d, r in zip(feat_rgbd, feat_rgb)) / len(feat_rgbd)
            return out


class PackNet01(nn.Module):
    """The original PackNet (CVPR'20), RGB only, versions 1A and 1B
    (``packnet.py:275-292``, reference ``networks/depth/PackNet01.py``):
    the encoder and the decoder of :class:`PackNetSAN`, no SAN ladder and
    no fusion parameters, widths :data:`FULL_CHANNELS` unless ``channels``
    are given.  ``forward(rgb, input_depth=None, generator=None,
    rgb_edge=None)`` takes the task's call and ignores the LiDAR and
    ``rgb_edge``, as the JAX module's ``**kwargs`` does; it returns
    ``{'inv_depths': [4 x [B,h,w,1]]}`` in training and at eval.
    ``generator`` feeds the dropout draws in training.  A call is the span
    ``mte.net.forward``."""

    default_channels = FULL_CHANNELS

    def __init__(self, channels=None, version='1A', dropout=None):
        super().__init__()
        channels = tuple(channels or self.default_channels)
        self.encoder = PackNetSlimEncoder(channels, dropout=dropout)
        self.decoder = PackNetDecoder(channels, 1, decoder_version(version))

    def forward(self, rgb, input_depth=None, generator=None, rgb_edge=None):
        with span('mte.net.forward'):
            x = _nchw(rgb)
            keeps = (self.encoder.dropout_keeps(x.shape[0], x.device, generator)
                     if self.training else None)
            return {'inv_depths': _nhwc(self.decoder(*self.encoder(x, keeps)))}


class PackNetSlim01(PackNet01):
    """:class:`PackNet01` at :data:`SLIM_CHANNELS` (``packnet.py:295-297``,
    reference ``networks/depth/PackNetSlim01.py``)."""

    default_channels = SLIM_CHANNELS


def init_weights(model, seed=0):
    """Xavier-uniform convs with zero bias, as the reference ``init_weights``
    (``PackNetSAN01.py:214-220``), drawn from ``seed``.  The model must lie
    on the CPU, where the generator is."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                w = m.weight
                rf = w[0, 0].numel()
                bound = math.sqrt(6.0 / (w.shape[1] * rf + w.shape[0] * rf))
                w.uniform_(-bound, bound, generator=gen)
                m.bias.zero_()
            elif isinstance(m, MinkConv):
                m.reset_parameters(gen)
    return model


def _cuda_fp32(device):
    """On CUDA, for the process: cuDNN's autotuner on, and TF32 off in convs
    and matmuls."""
    if device.type == 'cuda':
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def to_device(model, device=None, dtype=torch.float32):
    """``model`` in eval mode on ``device`` (``None`` -> CUDA, which must be
    present), its floating parameters and buffers cast once to ``dtype``
    (bf16 for ``serve.build``'s bf16 serving; the tasks keep fp32 masters
    and cast per call).  Every inference entry point builds its model
    through here.

    On CUDA this sets, for the process, cuDNN's autotuner on
    (``torch.backends.cudnn.benchmark``: cuDNN's heuristics pick an
    FFT-tiling algorithm for the 3x3 convs with 256 inputs at 48x160 that
    made a batch-4 request 7x slower on an H100, PERF.md; the first forward
    at each input shape pays for the tuning) and TF32 off in convs and
    matmuls: the fp32 path runs in strict fp32, the precision of the JAX
    reference and of every parity test (PyTorch's default lets cuDNN's
    convs run in TF32).  bf16 convs do not read the flag.  The 4-D conv
    weights are laid out once in the activations' layout
    (``ops/blocks.lay_out_weights``: channels-last in bf16 on the card).
    """
    device = resolve_device(device)
    _cuda_fp32(device)
    return lay_out_weights(model.to(device=device, dtype=dtype).eval())


def to_train_device(model, device=None):
    """``model`` in training mode on ``device``, for the training entry
    points, with the settings of :func:`to_device`.  The model stays fp32:
    it holds the master weights and running statistics, which a bf16
    training step updates in fp32 (``tasks.BaseTask.run_depth``)."""
    device = resolve_device(device)
    _cuda_fp32(device)
    return model.to(device).train()
