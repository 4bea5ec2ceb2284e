"""Masked-dense SAN ladder, NCHW, eval path: counterpart of
``mindtheedge_tpu/ops/sparse.py``.

The sparse LiDAR branch stays dense and carries an activity mask, as the
JAX package does.  Parameter names follow the reference
``MinkowskiEncoder``: SAN conv weights keep MinkowskiEngine's shape
``[K^2, I, O]`` with the first (row) coordinate varying fastest
(``utils/torch_port.py:32-42``), under
``mconvs.{lvl}.layer{n}.{3j}.kernel``; batch norms sit at
``layer{n}.{3j+1}.bn`` and ``layer_final.0.bn``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def masked_max_pool_3x3_s2(x, mask):
    """3x3 stride-2 max-pool over active sites (``sparse.py:63-70``).

    ``x``: [B,C,H,W]; ``mask``: [B,1,H,W] in {0,1}.  Output site (i,j) is
    active iff any input of its 2x2 cell {2i,2i+1}x{2j,2j+1} is active; its
    value is the max over the active inputs of the centred 3x3 window, and 0
    at inactive sites.  Returns (pooled, new_mask).
    """
    neg = torch.finfo(x.dtype).min
    pooled = F.max_pool2d(torch.where(mask > 0, x, neg), 3, 2, padding=1)
    new_mask = (F.max_pool2d(mask, 2, 2, ceil_mode=True) > 0).to(x.dtype)
    return torch.where(new_mask > 0, pooled, 0.0), new_mask


class MaskedBatchNorm(nn.Module):
    """Sparse batch norm in eval: running statistics, output re-zeroed at
    inactive sites (``sparse.py:240-248``).  Holds a ``BatchNorm1d`` as
    ``bn`` so the keys match the reference ``MinkowskiBatchNorm``."""

    def __init__(self, num_features):
        super().__init__()
        self.bn = nn.BatchNorm1d(num_features)

    def forward(self, x, mask):
        bn = self.bn
        inv = torch.rsqrt(bn.running_var + bn.eps)
        gain = inv * bn.weight
        off = bn.bias - bn.running_mean * inv * bn.weight
        y = x.float() * gain[:, None, None] + off[:, None, None]
        return (y * mask).to(x.dtype)


class MinkConv(nn.Module):
    """Bias-free sparse conv weight in MinkowskiEngine layout [K^2, I, O]."""

    def __init__(self, in_channels, out_channels, kernel_size):
        super().__init__()
        self.kernel_size = kernel_size
        self.kernel = nn.Parameter(torch.empty(
            kernel_size * kernel_size, in_channels, out_channels))

    def conv_weight(self):
        """[K^2, I, O] (row fastest) -> conv2d weight [O, I, kh, kw]."""
        k = self.kernel_size
        kk, i, o = self.kernel.shape
        return self.kernel.reshape(k, k, i, o).permute(3, 2, 1, 0)

    def reset_parameters(self, generator=None):
        kk, i, o = self.kernel.shape
        bound = math.sqrt(6.0 / (kk * i + kk * o))     # xavier-uniform
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)


class MinkConvBlock(nn.Module):
    """One SAN level (``sparse.py:449-476``): masked pool, three sparse conv
    stacks of 1, 2 and 3 convs (no bias) summed, masked BN, ReLU.

    The three first-stage convs read the same input and run as one conv with
    their weights concatenated, as in the JAX package.  Conv inputs are zero
    at inactive sites (pool and BN outputs), and every conv output goes
    through a MaskedBatchNorm that re-zeroes them, so no mask multiply is
    needed between the convs.
    """

    def __init__(self, in_channels, out_channels, kernel_size):
        super().__init__()
        c, k = out_channels, kernel_size
        self.out_channels, self.kernel_size = c, k
        self.layer1 = nn.Sequential(MinkConv(in_channels, c, k))
        self.layer2 = nn.Sequential(
            MinkConv(in_channels, 2 * c, k), MaskedBatchNorm(2 * c), nn.ReLU(),
            MinkConv(2 * c, c, k))
        self.layer3 = nn.Sequential(
            MinkConv(in_channels, 2 * c, k), MaskedBatchNorm(2 * c), nn.ReLU(),
            MinkConv(2 * c, 2 * c, k), MaskedBatchNorm(2 * c), nn.ReLU(),
            MinkConv(2 * c, c, k))
        self.layer_final = nn.Sequential(MaskedBatchNorm(c), nn.ReLU())

    def forward(self, x, mask):
        x, mask = masked_max_pool_3x3_s2(x, mask)
        c, p = self.out_channels, self.kernel_size // 2
        l2, l3 = self.layer2, self.layer3

        def conv(t, mink):
            return F.conv2d(t, mink.conv_weight(), padding=p)

        first = torch.cat([self.layer1[0].conv_weight(), l2[0].conv_weight(),
                           l3[0].conv_weight()], 0)
        x1, x2, x3 = F.conv2d(x, first, padding=p).split([c, 2 * c, 2 * c], 1)
        x2 = conv(F.relu(l2[1](x2, mask)), l2[3])
        x3 = conv(F.relu(l3[1](x3, mask)), l3[3])
        x3 = conv(F.relu(l3[4](x3, mask)), l3[6])
        return F.relu(self.layer_final[0](x1 + x2 + x3, mask)), mask


class SparseDepthEncoder(nn.Module):
    """The SAN ladder (``sparse.py:479-500``): sparse depth [B,1,H,W] -> one
    feature map per level (strides 2..32), zeros at inactive sites."""

    def __init__(self, channels=(32, 64, 128, 256, 512)):
        super().__init__()
        kernel_sizes = [5, 5] + [3] * (len(channels) - 1)
        ins = (1,) + tuple(channels[:-1])
        self.mconvs = nn.ModuleList(
            MinkConvBlock(i, c, k)
            for i, c, k in zip(ins, channels, kernel_sizes))

    def forward(self, depth):
        mask = (depth > 0).to(depth.dtype)
        x, outs = depth, []
        for level in self.mconvs:
            x, mask = level(x, mask)
            outs.append(x)
        return outs
