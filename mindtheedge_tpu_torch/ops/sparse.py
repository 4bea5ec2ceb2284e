"""Masked-dense SAN ladder, NCHW: counterpart of
``mindtheedge_tpu/ops/sparse.py``.

The sparse LiDAR branch stays dense and carries an activity mask, as the
JAX package does.  Parameter names follow the reference
``MinkowskiEncoder``: SAN conv weights keep MinkowskiEngine's shape
``[K^2, I, O]`` with the first (row) coordinate varying fastest
(``utils/torch_port.py:32-42``), under
``mconvs.{lvl}.layer{n}.{3j}.kernel``; batch norms sit at
``layer{n}.{3j+1}.bn`` and ``layer_final.0.bn``.

Under spatial sharding (``parallel/spatial.py``) ``MinkConvBlock`` and
``MaskedBatchNorm`` carry the ``space`` that ``spatial.shard_network``
sets: the pool and the convs take halos, and the training statistics are
summed over the frame's blocks.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops.remat import recomputing
from mindtheedge_tpu_torch.parallel import spatial


def masked_max_pool_3x3_s2(x, mask, space=None):
    """3x3 stride-2 max-pool over active sites (``sparse.py:63-70``).

    ``x``: [B,C,H,W]; ``mask``: [B,1,H,W] in {0,1}.  Output site (i,j) is
    active iff any input of its 2x2 cell {2i,2i+1}x{2j,2j+1} is active; its
    value is the max over the active inputs of the centred 3x3 window, and 0
    at inactive sites.  Returns (pooled, new_mask).

    Inactive inputs enter the max as the dtype's finite minimum.  The JAX
    pool casts float32's minimum to the activation's dtype, which in bf16
    rounds to -inf; the two sentinels give equal maps, since an output site
    with no active input is zeroed either way (tests/test_torch_bf16.py).

    Under ``space`` (``sparse.py:78-100``) the local extents of the
    sharded dimensions must be even; ``x`` and ``mask`` take their halos
    apart, so the zero rows at the grid's edges have mask 0 and enter as
    the minimum, as the global padding does.
    """
    neg = torch.finfo(x.dtype).min
    if space is None:
        pooled = F.max_pool2d(torch.where(mask > 0, x, neg), 3, 2, padding=1)
    else:
        pad = [1, 1, 1, 1]          # W then H, as F.pad takes them
        for dim, _ in space.lines():
            if x.shape[dim] % 2:
                raise ValueError(f'the spatial pool needs even local extents, not '
                                 f'{tuple(x.shape[-2:])}')
            pad[2 * (-1 - dim):2 * (-1 - dim) + 2] = [0, 0]
        xh = spatial.halo_exchange(x, 1, space)
        mh = spatial.halo_exchange(mask, 1, space)
        pooled = F.max_pool2d(F.pad(torch.where(mh > 0, xh, neg), pad, value=neg), 3, 2)
    new_mask = (F.max_pool2d(mask, 2, 2, ceil_mode=True) > 0).to(x.dtype)
    return torch.where(new_mask > 0, pooled, 0.0), new_mask


class MaskedBatchNorm(nn.Module):
    """Sparse batch norm (``sparse.py:185-248``), output re-zeroed at
    inactive sites.  Holds a ``BatchNorm1d`` as ``bn`` so the keys match the
    reference ``MinkowskiBatchNorm``; its statistics are computed here, not
    by ``BatchNorm1d``.

    In training the mean and the *biased* variance run over the active
    sites only, in fp32, with ``count = max(mask.sum(), 1)``, and gradients
    flow through both; the running statistics decay by ``DECAY`` (torch
    momentum 0.1), except while the backward recomputes the module
    (``ops/remat.py``).  The update is fp32 in every precision: it lands in
    the module's own buffers, fp32 where the master weights are, and the
    old value is not rounded to bf16 first as the JAX package's bf16 step
    may round it (a kept difference, ROADMAP Queue 3).  In eval the running
    statistics normalise, cast to the activation's dtype as the JAX package
    casts them.

    Under ``space`` the training statistics cover the whole frame
    (``sparse.py:220-236``): ``count`` and the sum are summed over the
    blocks, then the squared deviations from the global mean; the running
    statistics take the global values, equal on every block.  The sums
    stay fp32 in bf16 too.  ``parallel/mesh.make_sharded_train_step``
    sets a ``space`` of every rank, one chunk of the batch each: the
    statistics then cover the global batch.
    """

    DECAY = 0.9
    space = None

    def __init__(self, num_features):
        super().__init__()
        self.bn = nn.BatchNorm1d(num_features)

    def forward(self, x, mask):
        bn = self.bn
        if self.training:
            xf = x.float()
            count, total = mask.float().sum(), (xf * mask).sum((0, 2, 3))
            if self.space is not None:
                both = spatial.space_all_reduce(torch.cat([count[None], total]), self.space)
                count, total = both[0], both[1:]
            count = torch.clamp(count, min=1.0)
            mean = total / count
            sq = ((xf - mean[:, None, None]) ** 2 * mask).sum((0, 2, 3))
            if self.space is not None:
                sq = spatial.space_all_reduce(sq, self.space)
            var = sq / count
            if not recomputing():
                with torch.no_grad():
                    bn.running_mean.mul_(self.DECAY).add_(mean, alpha=1 - self.DECAY)
                    bn.running_var.mul_(self.DECAY).add_(var, alpha=1 - self.DECAY)
                    bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean.to(x.dtype), bn.running_var.to(x.dtype)
        inv = torch.rsqrt(var + bn.eps)
        gain = inv * bn.weight
        off = bn.bias - mean * inv * bn.weight
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

    space = None

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
        space = self.space
        x, mask = masked_max_pool_3x3_s2(x, mask, space)
        c = self.out_channels
        l2, l3 = self.layer2, self.layer3

        def conv(t, weight):
            return spatial.sharded_conv(t, weight, None, space)

        first = torch.cat([self.layer1[0].conv_weight(), l2[0].conv_weight(),
                           l3[0].conv_weight()], 0)
        x1, x2, x3 = conv(x, first).split([c, 2 * c, 2 * c], 1)
        x2 = conv(F.relu(l2[1](x2, mask)), l2[3].conv_weight())
        x3 = conv(F.relu(l3[1](x3, mask)), l3[3].conv_weight())
        x3 = conv(F.relu(l3[4](x3, mask)), l3[6].conv_weight())
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
