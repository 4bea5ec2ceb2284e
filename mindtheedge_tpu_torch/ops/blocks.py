"""PackNet building blocks on [B,C,H,W]: the plain formulation of
``mindtheedge_tpu/ops/blocks.py``.

Module and parameter names follow the reference PackNetSAN01 layers
(``Conv2D`` with ``conv_base``/``normalize``, ``conv3d``, ``conv1``), so the
``state_dict`` keys are the ones ``mindtheedge_tpu/utils/torch_port.py``
reads.  The JAX package's TPU layout rewrites (phase packing, W-lane packing,
pack2d-domain convs, the composed pack-layer kernel) compute the same
functions and are not ported.

Under spatial sharding (``parallel/spatial.py``) each block's ``space``
is set by ``spatial.shard_network``: its convs with ``k > 1`` then take a
halo from the neighbouring blocks and run unpadded in the sharded
dimensions, and GroupNorm takes its statistics over the whole frame.  With
``space`` None (the default) every block computes as before.

The activations' layout follows :func:`nhwc`: NHWC (``torch.channels_last``)
where they are bf16 on the card and the network is unsharded, NCHW elsewhere.
The layout is set where a tensor is made (the conv weights, by
:func:`weight_format` and :func:`lay_out_weights`; the GroupNorm + ELU
kernel's output) and every op in between keeps the layout it is given.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops.cuda import conv3d_kernel, gn_elu_kernel
from mindtheedge_tpu_torch.ops.packing import pack2d, unpack2d
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.utils.profiling import span


def nhwc(dtype, device, space=None):
    """The activation layout rule: True (NHWC, ``torch.channels_last``) where
    the activations are bf16 on the card and the block is unsharded
    (``space`` None), False (NCHW) elsewhere.  cuDNN's bf16 convs are NHWC
    and transpose NCHW operands around every call; its fp32 convs are NCHW;
    the CPU and spatial sharding (``parallel/spatial.py``) keep NCHW."""
    return dtype == torch.bfloat16 and torch.device(device).type == 'cuda' and space is None


def weight_format(dtype, device, space=None):
    """The memory format of a 4-D conv weight on the activations' path
    (:func:`nhwc`), so that cuDNN does not copy it a call."""
    return torch.channels_last if nhwc(dtype, device, space) else torch.contiguous_format


def lay_out_weights(net, space=None):
    """Lay ``net``'s 4-D conv weights out in :func:`weight_format` of their
    own dtype and device, in place -> ``net``.  ``models/packnet.to_device``
    and ``spatial.shard_network`` call it; the training step casts its fp32
    masters per step (``models/tasks.py``)."""
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 4:
                p.data = p.data.contiguous(memory_format=weight_format(p.dtype, p.device, space))
    return net


class GroupNorm(nn.GroupNorm):
    """GroupNorm(16 groups, eps 1e-5) with fp32 statistics (``blocks.py:74-131``).

    The activation and the parameters share one dtype (bf16 under
    ``arch.precision: bfloat16``); ``F.group_norm`` accumulates the
    statistics in fp32 for bf16 input and rounds the output once, where the
    JAX package rounds its fp32 scale and shift to bf16 first.  Both stay
    inside the bf16 band of tests/test_torch_bf16.py.  (On the card ATen's
    bf16 kernels keep the mean and rstd in bf16; the NHWC path's kernel
    pair, :meth:`elu`, keeps them in fp32.)  Under ``space`` the statistics
    are the whole frame's (``spatial.group_norm``).
    """

    space = None

    def __init__(self, num_channels, num_groups=16, eps=1e-5):
        super().__init__(num_groups, num_channels, eps)

    def forward(self, x):
        if self.space is not None:
            return spatial.group_norm(x, self.num_groups, self.weight, self.bias,
                                      self.eps, self.space)
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)

    def elu(self, x):
        """ELU of this GroupNorm of ``x``: on the NHWC path (:func:`nhwc`)
        the kernel pair ``csrc/gn_elu_kernel.cu``, which keeps ``x``'s
        layout and rounds once; sharded on the card the same arithmetic,
        ``F.elu`` of ``spatial.group_norm``'s fp32 output rounded once;
        elsewhere ``F.elu`` of :meth:`forward` (ATen's GroupNorm, whose CUDA
        kernels read NCHW; on the CPU a bf16 output rounds twice, as the JAX
        package's does)."""
        if nhwc(x.dtype, x.device, self.space):
            return gn_elu_kernel.GroupNormEluFn.apply(x, self.weight, self.bias, self.eps)
        if self.space is not None and x.device.type == 'cuda':
            return F.elu(self(x.float())).to(x.dtype)
        return F.elu(self(x))


class ConvBlock(nn.Module):
    """Zero pad k//2, conv, GroupNorm(16), ELU (reference ``Conv2D``)."""

    space = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1):
        super().__init__()
        self.conv_base = nn.Conv2d(in_channels, out_channels, kernel_size,
                                   stride, padding=kernel_size // 2)
        self.normalize = GroupNorm(out_channels)

    def forward(self, x):
        conv = self.conv_base
        return self.normalize.elu(spatial.sharded_conv(x, conv.weight, conv.bias, self.space,
                                                       conv.stride[0]))


def dropout_keep(batch, channels, rate, device, generator=None):
    """The keep mask of :func:`channel_dropout`: [B,C,1,1] booleans, one
    draw per (image, channel) from ``generator``."""
    return torch.rand(batch, channels, 1, 1, device=device, generator=generator) >= rate


def channel_dropout(x, rate, keep):
    """Dropout2d of [B,C,H,W]: whole channels drop with probability
    ``rate``, the kept ones are divided by 1 - rate (flax ``nn.Dropout`` with
    ``broadcast_dims=(1, 2)``, ``blocks.py:517-520``).  ``keep`` is the
    mask of :func:`dropout_keep`, drawn by the caller before the forward
    (``models/packnet.PackNetSAN.run_network``), so that a recompute of the
    forward in the backward does not draw again."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


class ResidualConv(nn.Module):
    """Two ConvBlocks plus a 1x1 shortcut; GroupNorm + ELU of the sum
    (``blocks.py:510-524``).  In training, ``dropout`` drops whole channels
    of the shortcut by the mask ``keep`` (:func:`channel_dropout`), which
    it then needs; in eval it does nothing."""

    def __init__(self, in_channels, out_channels, stride=1, dropout=None):
        super().__init__()
        self.conv1 = ConvBlock(in_channels, out_channels, 3, stride)
        self.conv2 = ConvBlock(out_channels, out_channels, 3, 1)
        self.conv3 = nn.Conv2d(in_channels, out_channels, 1, stride)
        self.normalize = GroupNorm(out_channels)
        self.dropout = dropout

    def forward(self, x, keep=None):
        shortcut = self.conv3(x)
        if self.dropout and self.training:
            shortcut = channel_dropout(shortcut, self.dropout, keep)
        return self.normalize.elu(self.conv2(self.conv1(x)) + shortcut)


class ResidualBlock(nn.Sequential):
    """A stack of ResidualConvs; the first may change channels and stride.
    ``keeps`` holds one dropout mask per block (:meth:`dropout_keeps`)."""

    def __init__(self, in_channels, out_channels, num_blocks, stride=1,
                 dropout=None):
        super().__init__(*[
            ResidualConv(in_channels if i == 0 else out_channels, out_channels,
                         stride if i == 0 else 1, dropout)
            for i in range(num_blocks)])

    def dropout_keeps(self, batch, device, generator=None):
        """Each block's dropout mask, drawn in the order the blocks run."""
        return [dropout_keep(batch, block.conv3.out_channels, block.dropout,
                             device, generator) for block in self]

    def forward(self, x, keeps=None):
        for i, block in enumerate(self):
            x = block(x, None if keeps is None else keeps[i])
        return x


class InvDepthHead(nn.Module):
    """3x3 conv (zero pad 1), sigmoid / min_depth (``blocks.py:609-611``)."""

    space = None

    def __init__(self, in_channels, out_channels=1, min_depth=0.5):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.min_depth = min_depth

    def forward(self, x):
        y = spatial.sharded_conv(x, self.conv1.weight, self.conv1.bias, self.space)
        return torch.sigmoid(y) / self.min_depth


class Conv3dOverChannels(nn.Conv3d):
    """3x3x3 conv over (channel-as-depth, H, W), 1 input feature -> d.

    [B,D,H,W] -> [B,d*D,H,W]: output channel feat*D + depth, with the bias of
    feature f on every depth of f (``blocks.py:636-654, 706``).  Zero pad 1
    on all three axes.  The conv is the span ``mte.net.conv3d``
    (``utils/profiling.py``).  Unsharded on the card it is the kernel
    ``csrc/conv3d_kernel.cu`` (``ops/cuda/conv3d_kernel``), which takes
    float32 and bfloat16, NCHW or channels-last, returns its input's layout
    and raises on any other dtype; on the CPU ``F.conv3d``, its plain
    version; under ``space`` the sharded conv.
    """

    space = None

    def __init__(self, d):
        super().__init__(1, d, 3, padding=1)

    def forward(self, x):
        b, depth, h, w = x.shape
        with span('mte.net.conv3d'):
            if self.space is None and x.is_cuda:
                return conv3d_kernel.Conv3dOverChannelsFn.apply(x, self.weight, self.bias)
            y = spatial.sharded_conv(x.unsqueeze(1), self.weight, self.bias,  # [B,d,D,H,W]
                                     self.space)
        return y.reshape(b, self.out_channels * depth, h, w)


class PackLayerConv3d(nn.Module):
    """pack2d(r), conv3d (1 -> d, with bias), ConvBlock back to C channels.

    The ConvBlock zero-pads the *biased* conv3d output (``blocks.py:812-816,
    887-910``); under spatial sharding the zeros at the grid's edges do
    it, and ``pack2d`` checks that the local extents are even.
    """

    space = None

    def __init__(self, in_channels, kernel_size, r=2, d=8):
        super().__init__()
        self.r = r
        self.conv3d = Conv3dOverChannels(d)
        self.conv = ConvBlock(in_channels * r * r * d, in_channels, kernel_size)

    def forward(self, x):
        return self.conv(self.conv3d(pack2d(x, self.r, self.space)))


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
