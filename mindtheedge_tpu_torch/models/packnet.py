"""PackNet-SAN depth network: counterpart of
``mindtheedge_tpu/models/packnet.py`` (reference ``PackNetSAN01.py``).

NCHW inside; ``PackNetSAN.forward`` takes and returns NHWC like the JAX
module.  The ``state_dict`` keys are the reference PackNetSAN01 names.
"""

import math

import torch
import torch.nn as nn

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.config.defaults import REMAT_MODES, checked
from mindtheedge_tpu_torch.ops import remat
from mindtheedge_tpu_torch.ops.blocks import (
    ConvBlock, InvDepthHead, PackLayerConv3d, ResidualBlock, UnpackLayerConv3d)
from mindtheedge_tpu_torch.ops.packing import upsample_nearest2x
from mindtheedge_tpu_torch.ops.sparse import MinkConv, SparseDepthEncoder

# Encoder/decoder widths (PackNetSAN01.py:179-184)
SLIM_CHANNELS = (32, 32, 64, 128, 256, 512)
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

    def dropout_keeps(self, batch, device, generator=None):
        """The dropout masks of one training forward (one list per residual
        stack), drawn from ``generator`` in the order the forward runs the
        blocks; None without dropout."""
        stacks = (self.conv2, self.conv3, self.conv4, self.conv5)
        if not stacks[0][0].dropout:
            return None
        return [s.dropout_keeps(batch, device, generator) for s in stacks]

    def forward(self, rgb, keeps=None):
        keeps = keeps or (None,) * 4
        x = self.pre_calc(rgb)
        x1p = self.pack1(self.conv1(x))
        x2p = self.pack2(self.conv2(x1p, keeps[0]))
        x3p = self.pack3(self.conv3(x2p, keeps[1]))
        x4p = self.pack4(self.conv4(x3p, keeps[2]))
        x5p = self.pack5(self.conv5(x4p, keeps[3]))
        return x5p, [x, x1p, x2p, x3p, x4p]


class PackNetDecoder(nn.Module):
    """Reference ``Decoder``, version A (concatenated skips); returns the
    inverse depths at strides 1, 2, 4, 8."""

    def __init__(self, channels=SLIM_CHANNELS, out_channels=1):
        super().__init__()
        ni, n1, n2, n3, n4, n5 = channels
        d, o = NUM_3D_FEAT, out_channels
        self.unpack5 = UnpackLayerConv3d(n5, n5, UNPACK_KERNEL[0], d=d)
        self.unpack4 = UnpackLayerConv3d(n5, n4, UNPACK_KERNEL[1], d=d)
        self.unpack3 = UnpackLayerConv3d(n4, n3, UNPACK_KERNEL[2], d=d)
        self.unpack2 = UnpackLayerConv3d(n3, n2, UNPACK_KERNEL[3], d=d)
        self.unpack1 = UnpackLayerConv3d(n2, n1, UNPACK_KERNEL[4], d=d)
        self.iconv5 = ConvBlock(n5 + n4, n5, ICONV_KERNEL[0])
        self.iconv4 = ConvBlock(n4 + n3, n4, ICONV_KERNEL[1])
        self.iconv3 = ConvBlock(n3 + n2 + o, n3, ICONV_KERNEL[2])
        self.iconv2 = ConvBlock(n2 + n1 + o, n2, ICONV_KERNEL[3])
        self.iconv1 = ConvBlock(n1 + ni + o, n1, ICONV_KERNEL[4])
        self.disp4_layer = InvDepthHead(n4, o)
        self.disp3_layer = InvDepthHead(n3, o)
        self.disp2_layer = InvDepthHead(n2, o)
        self.disp1_layer = InvDepthHead(n1, o)

    def forward(self, x5p, skips):
        skip1, skip2, skip3, skip4, skip5 = skips
        iconv5 = self.iconv5(torch.cat([self.unpack5(x5p), skip5], 1))
        iconv4 = self.iconv4(torch.cat([self.unpack4(iconv5), skip4], 1))
        inv_depth4 = self.disp4_layer(iconv4)
        iconv3 = self.iconv3(torch.cat(
            [self.unpack3(iconv4), skip3, upsample_nearest2x(inv_depth4)], 1))
        inv_depth3 = self.disp3_layer(iconv3)
        iconv2 = self.iconv2(torch.cat(
            [self.unpack2(iconv3), skip2, upsample_nearest2x(inv_depth3)], 1))
        inv_depth2 = self.disp2_layer(iconv2)
        iconv1 = self.iconv1(torch.cat(
            [self.unpack1(iconv2), skip1, upsample_nearest2x(inv_depth2)], 1))
        inv_depth1 = self.disp1_layer(iconv1)
        return [inv_depth1, inv_depth2, inv_depth3, inv_depth4]


class PackNetSAN(nn.Module):
    """PackNet-SAN version 1A (``packnet.py:181-272``).

    ``forward(rgb [B,H,W,3], input_depth [B,H,W,1] or None, generator)``,
    NHWC in and out:

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

    ``generator`` feeds the encoder's dropout draws in training: each pass
    draws its masks before it runs the encoder, in the order the blocks
    use them.  ``remat`` (True or ``'conv'``, ``ops/remat.py``) recomputes
    the encoder, the SAN ladder and the decoder in the backward of a
    training pass, as the JAX package's ``nn.remat`` does (``'conv'`` keeps
    every conv's output); the loss, the gradients, the running statistics
    and the generator's state are those of the pass without it.
    ``version`` and ``input_channels`` are the config's
    (``tasks.build_depth_net``); only 1A on RGB is ported: the 4-channel
    ``rgb_edge`` input and versions other than 1A raise (ROADMAP Queue 1
    item 10).  The config's ``freeze_*`` flags are the optimizer's: it
    leaves those parameters out (``training/optimizer.py``), as the JAX
    package does.

    The module computes in the dtype of its parameters and inputs: bf16
    where ``tasks.BaseTask.run_depth`` hands it bf16 casts of its fp32
    parameters, or where :func:`to_device` casts it once for serving.
    """

    def __init__(self, channels=SLIM_CHANNELS, version='1A', input_channels=3,
                 output_channels=1, dropout=None, remat=False):
        super().__init__()
        if version != '1A':
            raise NotImplementedError(
                f'PackNetSAN version {version!r}: only 1A is ported '
                '(ROADMAP Queue 1 item 10)')
        if input_channels != 3:
            raise NotImplementedError(
                f'PackNetSAN with input_channels={input_channels} (rgb_edge '
                'input) waits for ROADMAP Queue 1 item 10')
        self.remat = checked('model.depth_net.remat', remat, REMAT_MODES)
        self.encoder = PackNetSlimEncoder(channels, dropout=dropout)
        self.decoder = PackNetDecoder(channels, output_channels)
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
        """NCHW: rgb [B,3,H,W], input_depth [B,1,H,W] -> (4 inverse depths,
        the 6 fused skip features)."""
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

    def forward(self, rgb, input_depth=None, generator=None):
        rgb = rgb.permute(0, 3, 1, 2)
        lidar = None if input_depth is None else input_depth.permute(0, 3, 1, 2)
        nhwc = lambda ts: [t.permute(0, 2, 3, 1) for t in ts]
        if not self.training:
            return {'inv_depths': nhwc(self.run_network(rgb, lidar)[0])}
        inv_rgb, feat_rgb = self.run_network(rgb, None, generator)
        out = {'inv_depths': nhwc(inv_rgb)}
        if lidar is None:
            return out
        inv_rgbd, feat_rgbd = self.run_network(rgb, lidar, generator)
        out['inv_depths_rgbd'] = nhwc(inv_rgbd)
        out['depth_loss'] = sum(
            torch.mean((d.detach().float() - r.float()) ** 2)
            for d, r in zip(feat_rgbd, feat_rgb)) / len(feat_rgbd)
        return out


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
    convs run in TF32).  bf16 convs do not read the flag.
    """
    device = resolve_device(device)
    _cuda_fp32(device)
    return model.to(device=device, dtype=dtype).eval()


def to_train_device(model, device=None):
    """``model`` in training mode on ``device``, for the training entry
    points, with the settings of :func:`to_device`.  The model stays fp32:
    it holds the master weights and running statistics, which a bf16
    training step updates in fp32 (``tasks.BaseTask.run_depth``)."""
    device = resolve_device(device)
    _cuda_fp32(device)
    return model.to(device).train()
