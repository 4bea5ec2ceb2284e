"""PackNet-SAN depth network: counterpart of
``mindtheedge_tpu/models/packnet.py`` (reference ``PackNetSAN01.py``).

NCHW inside; ``PackNetSAN.forward`` takes and returns NHWC like the JAX
module.  The ``state_dict`` keys are the reference PackNetSAN01 names.
"""

import math

import torch
import torch.nn as nn

from mindtheedge_tpu_torch import resolve_device
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

    def forward(self, rgb, generator=None):
        x = self.pre_calc(rgb)
        x1p = self.pack1(self.conv1(x))
        x2p = self.pack2(self.conv2(x1p, generator))
        x3p = self.pack3(self.conv3(x2p, generator))
        x4p = self.pack4(self.conv4(x3p, generator))
        x5p = self.pack5(self.conv5(x4p, generator))
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

    ``generator`` feeds the encoder's dropout draws in training.
    ``version`` and ``input_channels`` are the config's
    (``tasks.build_depth_net``); only 1A on RGB is ported: the 4-channel
    ``rgb_edge`` input and versions other than 1A raise (ROADMAP Queue 1
    item 10), and ``remat`` raises (item 23).  The config's ``freeze_*``
    flags are the optimizer's: it leaves those parameters out
    (``training/optimizer.py``), as the JAX package does.
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
        if remat:
            raise NotImplementedError(
                f'PackNetSAN remat={remat!r} (activation recomputation) waits '
                'for ROADMAP Queue 1 item 23')
        self.encoder = PackNetSlimEncoder(channels, dropout=dropout)
        self.decoder = PackNetDecoder(channels, output_channels)
        self.mconvs = SparseDepthEncoder(tuple(channels[1:]))
        self.weight = nn.Parameter(torch.ones(5))
        self.bias = nn.Parameter(torch.zeros(5))

    def run_network(self, rgb, input_depth=None, generator=None):
        """NCHW: rgb [B,3,H,W], input_depth [B,1,H,W] -> (4 inverse depths,
        the 6 fused skip features)."""
        x5p, skips = self.encoder(rgb, generator)
        if input_depth is not None:
            san = self.mconvs(input_depth)
            w, b = self.weight, self.bias
            for i in range(4):
                skips[i + 1] = skips[i + 1] * w[i] + san[i] + b[i]
            x5p = x5p * w[4] + san[4] + b[4]
        return self.decoder(x5p, skips), skips + [x5p]

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


def to_device(model, device=None):
    """``model`` in eval mode on ``device`` (``None`` -> CUDA, which must be
    present).  Every inference entry point builds its model through here.

    On CUDA this turns on cuDNN's autotuner for the process
    (``torch.backends.cudnn.benchmark``): cuDNN's heuristics pick an
    FFT-tiling algorithm for the 3x3 convs with 256 inputs at 48x160 that
    made a batch-4 request 7x slower on an H100 (PERF.md).  The first
    forward at each input shape pays for the tuning.
    """
    device = resolve_device(device)
    if device.type == 'cuda':
        torch.backends.cudnn.benchmark = True
    return model.to(device).eval()


def to_train_device(model, device=None):
    """``model`` in training mode on ``device``, for the training entry
    points: as :func:`to_device`, cuDNN's autotuner on, and TF32 off in
    convs and matmuls for the process, since training runs in strict fp32
    (``arch.precision: float32``; bf16 waits for ROADMAP item 9)."""
    device = resolve_device(device)
    if device.type == 'cuda':
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return model.to(device).train()
