"""PackNet building blocks, NCHW: the plain formulation of
``mindtheedge_tpu/ops/blocks.py``.

Module and parameter names follow the reference PackNetSAN01 layers
(``Conv2D`` with ``conv_base``/``normalize``, ``conv3d``, ``conv1``), so the
``state_dict`` keys are the ones ``mindtheedge_tpu/utils/torch_port.py``
reads.  The JAX package's TPU layout rewrites (phase packing, W-lane packing,
pack2d-domain convs, the composed pack-layer kernel) compute the same
functions and are not ported.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops.packing import pack2d, unpack2d


class GroupNorm(nn.GroupNorm):
    """GroupNorm(16 groups, eps 1e-5) with fp32 statistics (``blocks.py:74-131``)."""

    def __init__(self, num_channels, num_groups=16, eps=1e-5):
        super().__init__(num_groups, num_channels, eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class ConvBlock(nn.Module):
    """Zero pad k//2, conv, GroupNorm(16), ELU (reference ``Conv2D``)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1):
        super().__init__()
        self.conv_base = nn.Conv2d(in_channels, out_channels, kernel_size,
                                   stride, padding=kernel_size // 2)
        self.normalize = GroupNorm(out_channels)

    def forward(self, x):
        return F.elu(self.normalize(self.conv_base(x)))


class ResidualConv(nn.Module):
    """Two ConvBlocks plus a 1x1 shortcut; GroupNorm + ELU of the sum
    (``blocks.py:510-524``).  Eval only: the shortcut's Dropout2d is the
    identity there."""

    def __init__(self, in_channels, out_channels, stride=1):
        super().__init__()
        self.conv1 = ConvBlock(in_channels, out_channels, 3, stride)
        self.conv2 = ConvBlock(out_channels, out_channels, 3, 1)
        self.conv3 = nn.Conv2d(in_channels, out_channels, 1, stride)
        self.normalize = GroupNorm(out_channels)

    def forward(self, x):
        return F.elu(self.normalize(self.conv2(self.conv1(x)) + self.conv3(x)))


class ResidualBlock(nn.Sequential):
    """A stack of ResidualConvs; the first may change channels and stride."""

    def __init__(self, in_channels, out_channels, num_blocks, stride=1):
        super().__init__(*[
            ResidualConv(in_channels if i == 0 else out_channels, out_channels,
                         stride if i == 0 else 1)
            for i in range(num_blocks)])


class InvDepthHead(nn.Module):
    """3x3 conv (zero pad 1), sigmoid / min_depth (``blocks.py:609-611``)."""

    def __init__(self, in_channels, out_channels=1, min_depth=0.5):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.min_depth = min_depth

    def forward(self, x):
        return torch.sigmoid(self.conv1(x)) / self.min_depth


class Conv3dOverChannels(nn.Conv3d):
    """3x3x3 conv over (channel-as-depth, H, W), 1 input feature -> d.

    [B,D,H,W] -> [B,d*D,H,W]: output channel feat*D + depth, with the bias of
    feature f on every depth of f (``blocks.py:636-654, 706``).  Zero pad 1
    on all three axes.
    """

    def __init__(self, d):
        super().__init__(1, d, 3, padding=1)

    def forward(self, x):
        b, depth, h, w = x.shape
        y = super().forward(x.unsqueeze(1))            # [B,d,D,H,W]
        return y.reshape(b, self.out_channels * depth, h, w)


class PackLayerConv3d(nn.Module):
    """pack2d(r), conv3d (1 -> d, with bias), ConvBlock back to C channels.

    The ConvBlock zero-pads the *biased* conv3d output (``blocks.py:812-816,
    887-910``).
    """

    def __init__(self, in_channels, kernel_size, r=2, d=8):
        super().__init__()
        self.r = r
        self.conv3d = Conv3dOverChannels(d)
        self.conv = ConvBlock(in_channels * r * r * d, in_channels, kernel_size)

    def forward(self, x):
        return self.conv(self.conv3d(pack2d(x, self.r)))


class UnpackLayerConv3d(nn.Module):
    """ConvBlock to out*r^2/d, conv3d (1 -> d), pixel_shuffle(r)
    (``blocks.py:913-938``)."""

    def __init__(self, in_channels, out_channels, kernel_size, r=2, d=8):
        super().__init__()
        self.r = r
        self.conv = ConvBlock(in_channels, out_channels * r * r // d,
                              kernel_size)
        self.conv3d = Conv3dOverChannels(d)

    def forward(self, x):
        return unpack2d(self.conv3d(self.conv(x)), self.r)
