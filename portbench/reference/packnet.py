"""Plain PackNet-SAN 1A: the benchmark's reference network.

A frozen, functional copy of the published network (PackNetSAN01 with the
PackNetSlim encoder, MindTheEdge ``packnet_code``) in plain PyTorch, NCHW,
computing on a dict of tensors keyed by the reference ``state_dict`` names.
It imports nothing of the program: the benchmark makes the weights
(:func:`make_weights`) and hands the same dict to the program and to this
module.

``quant`` is applied to every convolution's input and weight: the identity
for the reference itself, a rounding to a lower precision for the control
(``reference/precision.py``).
"""

import math

import torch
import torch.nn.functional as F

NUM_BLOCKS = (2, 2, 3, 3)
PACK_KERNEL = (5, 3, 3, 3, 3)
UNPACK_KERNEL = (3, 3, 3, 3, 3)
ICONV_KERNEL = (3, 3, 3, 3, 3)
SAN_KERNEL = (5, 5, 3, 3, 3)
D3 = 4                  # 3-D conv features of the pack and unpack layers
GROUPS = 16             # GroupNorm groups
GN_EPS = 1e-5
BN_EPS = 1e-5           # MinkowskiBatchNorm / BatchNorm1d
BN_DECAY = 0.9          # running statistics: momentum 0.1
MIN_DEPTH = 0.5         # inverse-depth head: sigmoid / MIN_DEPTH


def _identity(t):
    return t


# -- parameters ---------------------------------------------------------------

def _conv_block(p, cin, cout, k):
    return [(f'{p}.conv_base.weight', (cout, cin, k, k), 'conv'),
            (f'{p}.conv_base.bias', (cout,), 'zero'),
            (f'{p}.normalize.weight', (cout,), 'one'),
            (f'{p}.normalize.bias', (cout,), 'zero')]


def _conv3d(p):
    return [(f'{p}.conv3d.weight', (D3, 1, 3, 3, 3), 'conv'),
            (f'{p}.conv3d.bias', (D3,), 'zero')]


def _residual(p, cin, cout):
    return (_conv_block(f'{p}.conv1', cin, cout, 3) + _conv_block(f'{p}.conv2', cout, cout, 3)
            + [(f'{p}.conv3.weight', (cout, cin, 1, 1), 'conv'),
               (f'{p}.conv3.bias', (cout,), 'zero'),
               (f'{p}.normalize.weight', (cout,), 'one'),
               (f'{p}.normalize.bias', (cout,), 'zero')])


def _masked_bn(p, c):
    return [(f'{p}.bn.weight', (c,), 'one'), (f'{p}.bn.bias', (c,), 'zero'),
            (f'{p}.bn.running_mean', (c,), 'zero'), (f'{p}.bn.running_var', (c,), 'one'),
            (f'{p}.bn.num_batches_tracked', (), 'count')]


def param_specs(channels):
    """[(name, shape, init)] of PackNet-SAN 1A at ``channels`` (ni, n1..n5),
    in the order :func:`make_weights` draws them.  ``init``: 'conv'
    (xavier-uniform), 'mink' (xavier-uniform of a ``[K^2, I, O]`` kernel),
    'zero', 'one', 'count' (an int64 0)."""
    ni, n1, n2, n3, n4, n5 = channels
    specs = [('weight', (5,), 'one'), ('bias', (5,), 'zero')]
    specs += _conv_block('encoder.pre_calc', 3, ni, 5)
    specs += _conv_block('encoder.conv1', ni, n1, 7)
    widths = (n1, n2, n3, n4, n5)
    for i in range(5):
        c = widths[i]
        if i:
            for j in range(NUM_BLOCKS[i - 1]):
                specs += _residual(f'encoder.conv{i + 1}.{j}', widths[i - 1] if j == 0 else c, c)
        specs += _conv3d(f'encoder.pack{i + 1}')
        specs += _conv_block(f'encoder.pack{i + 1}.conv', c * 4 * D3, c, PACK_KERNEL[i])
    unpack = [(5, n5, n5), (4, n5, n4), (3, n4, n3), (2, n3, n2), (1, n2, n1)]
    for (lvl, cin, cout), k in zip(unpack, UNPACK_KERNEL):
        specs += _conv_block(f'decoder.unpack{lvl}.conv', cin, cout * 4 // D3, k)
        specs += _conv3d(f'decoder.unpack{lvl}')
    iconv = [(5, n5 + n4, n5), (4, n4 + n3, n4), (3, n3 + n2 + 1, n3),
             (2, n2 + n1 + 1, n2), (1, n1 + ni + 1, n1)]
    for (lvl, cin, cout), k in zip(iconv, ICONV_KERNEL):
        specs += _conv_block(f'decoder.iconv{lvl}', cin, cout, k)
    for lvl, c in ((4, n4), (3, n3), (2, n2), (1, n1)):
        specs += [(f'decoder.disp{lvl}_layer.conv1.weight', (1, c, 3, 3), 'conv'),
                  (f'decoder.disp{lvl}_layer.conv1.bias', (1,), 'zero')]
    ins = (1, n1, n2, n3, n4)
    for lvl, (cin, c, k) in enumerate(zip(ins, widths, SAN_KERNEL)):
        p = f'mconvs.mconvs.{lvl}'
        kk = k * k
        specs += [(f'{p}.layer1.0.kernel', (kk, cin, c), 'mink'),
                  (f'{p}.layer2.0.kernel', (kk, cin, 2 * c), 'mink')]
        specs += _masked_bn(f'{p}.layer2.1', 2 * c)
        specs += [(f'{p}.layer2.3.kernel', (kk, 2 * c, c), 'mink'),
                  (f'{p}.layer3.0.kernel', (kk, cin, 2 * c), 'mink')]
        specs += _masked_bn(f'{p}.layer3.1', 2 * c)
        specs += [(f'{p}.layer3.3.kernel', (kk, 2 * c, 2 * c), 'mink')]
        specs += _masked_bn(f'{p}.layer3.4', 2 * c)
        specs += [(f'{p}.layer3.6.kernel', (kk, 2 * c, c), 'mink')]
        specs += _masked_bn(f'{p}.layer_final.0', c)
    return specs


def _bound(shape, init):
    """The xavier-uniform bound of a conv weight or a ``[K^2, I, O]`` kernel."""
    if init == 'mink':
        kk, i, o = shape
        return math.sqrt(6.0 / (kk * i + kk * o))
    rf = math.prod(shape[2:])
    return math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))


def make_weights(channels, seed, device):
    """The network's weights drawn on ``device`` from ``seed``, fp32: one
    uniform draw of every random element from a ``torch.Generator`` on the
    device, cut into xavier-uniform conv weights; biases and normalisation
    parameters at their published initial values."""
    specs = param_specs(channels)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s, init in specs if init in ('conv', 'mink')]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    weights, at = {}, 0
    for name, shape, init in specs:
        if init in ('conv', 'mink'):
            n = math.prod(shape)
            b = _bound(shape, init)
            weights[name] = (flat[at:at + n].view(shape) * (2 * b) - b).clone()
            at += n
        elif init == 'count':
            weights[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            fill = 1.0 if init == 'one' else 0.0
            weights[name] = torch.full(shape, fill, device=device)
    return weights


# -- blocks ------------------------------------------------------------------

class Net:
    """The network over the weights dict ``w`` (read, not copied), computing
    in ``dtype`` with conv operands passed through ``quant``.  Running
    statistics are read from ``w`` and, in a training pass, written back to
    it."""

    def __init__(self, w, dtype=torch.float32, quant=_identity):
        self.w, self.dtype, self.quant = w, dtype, quant

    def p(self, name):
        t = self.w[name]
        return t.to(self.dtype) if t.is_floating_point() else t

    def conv(self, x, weight, bias=None, pad=None):
        q = self.quant
        k = weight.shape[-1]
        pad = k // 2 if pad is None else pad
        fn = F.conv3d if weight.dim() == 5 else F.conv2d
        return fn(q(x), q(weight), bias, padding=pad)

    def conv_block(self, p, x):
        y = self.conv(x, self.p(f'{p}.conv_base.weight'), self.p(f'{p}.conv_base.bias'))
        return F.elu(F.group_norm(y, GROUPS, self.p(f'{p}.normalize.weight'),
                                  self.p(f'{p}.normalize.bias'), GN_EPS))

    def conv3d(self, p, x):
        """[B,D,H,W] -> [B,D3*D,H,W]: output channel feat*D + depth."""
        b, depth, h, w = x.shape
        y = self.conv(x.unsqueeze(1), self.p(f'{p}.conv3d.weight'), self.p(f'{p}.conv3d.bias'))
        return y.reshape(b, D3 * depth, h, w)

    def residual(self, p, x, keep, rate):
        shortcut = self.conv(x, self.p(f'{p}.conv3.weight'), self.p(f'{p}.conv3.bias'))
        if keep is not None:
            shortcut = torch.where(keep, shortcut / (1.0 - rate), 0.0)
        y = self.conv_block(f'{p}.conv2', self.conv_block(f'{p}.conv1', x)) + shortcut
        return F.elu(F.group_norm(y, GROUPS, self.p(f'{p}.normalize.weight'),
                                  self.p(f'{p}.normalize.bias'), GN_EPS))

    def pack(self, p, x):
        return self.conv_block(f'{p}.conv', self.conv3d(p, F.pixel_unshuffle(x, 2)))

    def unpack(self, p, x):
        return F.pixel_shuffle(self.conv3d(p, self.conv_block(f'{p}.conv', x)), 2)

    def head(self, p, x):
        y = self.conv(x, self.p(f'{p}.conv1.weight'), self.p(f'{p}.conv1.bias'))
        return torch.sigmoid(y) / MIN_DEPTH

    # -- the networks --------------------------------------------------------
    def encoder(self, rgb, keeps=None, rate=0.0):
        """rgb [B,3,H,W] -> (x5p, [x, x1p, x2p, x3p, x4p]); ``keeps`` the
        dropout masks of the 10 residual blocks in order (None at eval)."""
        x = self.conv_block('encoder.pre_calc', rgb)
        out = self.pack('encoder.pack1', self.conv_block('encoder.conv1', x))
        skips = [x, out]
        k = 0
        for i, blocks in enumerate(NUM_BLOCKS):
            for j in range(blocks):
                out = self.residual(f'encoder.conv{i + 2}.{j}', out,
                                    None if keeps is None else keeps[k], rate)
                k += 1
            out = self.pack(f'encoder.pack{i + 2}', out)
            skips.append(out)
        return skips[-1], skips[:-1]

    def decoder(self, x5p, skips):
        skip1, skip2, skip3, skip4, skip5 = skips
        up = lambda t: F.interpolate(t, scale_factor=2, mode='nearest')
        iconv5 = self.conv_block('decoder.iconv5', torch.cat(
            [self.unpack('decoder.unpack5', x5p), skip5], 1))
        iconv4 = self.conv_block('decoder.iconv4', torch.cat(
            [self.unpack('decoder.unpack4', iconv5), skip4], 1))
        inv4 = self.head('decoder.disp4_layer', iconv4)
        iconv3 = self.conv_block('decoder.iconv3', torch.cat(
            [self.unpack('decoder.unpack3', iconv4), skip3, up(inv4)], 1))
        inv3 = self.head('decoder.disp3_layer', iconv3)
        iconv2 = self.conv_block('decoder.iconv2', torch.cat(
            [self.unpack('decoder.unpack2', iconv3), skip2, up(inv3)], 1))
        inv2 = self.head('decoder.disp2_layer', iconv2)
        iconv1 = self.conv_block('decoder.iconv1', torch.cat(
            [self.unpack('decoder.unpack1', iconv2), skip1, up(inv2)], 1))
        inv1 = self.head('decoder.disp1_layer', iconv1)
        return [inv1, inv2, inv3, inv4]

    def masked_bn(self, p, x, mask, train):
        """Batch norm over the active sites, output zero elsewhere; in
        training the biased statistics of the active sites in fp32, and the
        running statistics decay by ``BN_DECAY``."""
        if train:
            xf = x.float()
            count = torch.clamp(mask.float().sum(), min=1.0)
            mean = (xf * mask).sum((0, 2, 3)) / count
            var = ((xf - mean[:, None, None]) ** 2 * mask).sum((0, 2, 3)) / count
            with torch.no_grad():
                for key, value in (('running_mean', mean), ('running_var', var)):
                    old = self.w[f'{p}.bn.{key}']
                    self.w[f'{p}.bn.{key}'] = old * BN_DECAY + value.detach() * (1 - BN_DECAY)
        else:
            mean = self.w[f'{p}.bn.running_mean'].to(x.dtype)
            var = self.w[f'{p}.bn.running_var'].to(x.dtype)
        weight, bias = self.w[f'{p}.bn.weight'], self.w[f'{p}.bn.bias']
        inv = torch.rsqrt(var + BN_EPS)
        y = x.float() * (inv * weight)[:, None, None] + (bias - mean * inv * weight)[:, None, None]
        return (y * mask).to(x.dtype)

    def mink(self, p, x):
        """A sparse conv as a dense conv of a ``[K^2, I, O]`` kernel whose
        first (row) offset varies fastest; inputs are zero off the sites."""
        kern = self.p(f'{p}.kernel')
        kk, i, o = kern.shape
        k = math.isqrt(kk)
        return self.conv(x, kern.reshape(k, k, i, o).permute(3, 2, 1, 0))

    def san_level(self, p, x, mask, train):
        neg = torch.finfo(x.dtype).min
        pooled = F.max_pool2d(torch.where(mask > 0, x, neg), 3, 2, padding=1)
        mask = (F.max_pool2d(mask, 2, 2, ceil_mode=True) > 0).to(x.dtype)
        x = torch.where(mask > 0, pooled, 0.0)
        bn = lambda name, t: F.relu(self.masked_bn(f'{p}.{name}', t, mask, train))
        x1 = self.mink(f'{p}.layer1.0', x)
        x2 = self.mink(f'{p}.layer2.3', bn('layer2.1', self.mink(f'{p}.layer2.0', x)))
        x3 = bn('layer3.1', self.mink(f'{p}.layer3.0', x))
        x3 = self.mink(f'{p}.layer3.6', bn('layer3.4', self.mink(f'{p}.layer3.3', x3)))
        return bn('layer_final.0', x1 + x2 + x3), mask

    def san(self, depth, train=False):
        mask = (depth > 0).to(depth.dtype)
        x, outs = depth, []
        for lvl in range(5):
            x, mask = self.san_level(f'mconvs.mconvs.{lvl}', x, mask, train)
            outs.append(x)
        return outs

    def run(self, rgb, depth=None, keeps=None, rate=0.0, train=False):
        """NCHW -> (4 inverse depths, the 6 fused skip features)."""
        x5p, skips = self.encoder(rgb, keeps, rate)
        if depth is not None:
            san = self.san(depth, train)
            wt, bs = self.p('weight'), self.p('bias')
            for i in range(4):
                skips[i + 1] = skips[i + 1] * wt[i] + san[i] + bs[i]
            x5p = x5p * wt[4] + san[4] + bs[4]
        return self.decoder(x5p, skips), skips + [x5p]


def nchw(t):
    return t.permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def infer(w, rgb, lidar, dtype=torch.float32, quant=_identity):
    """The eval forward: rgb [B,H,W,3] in [0, 1], lidar [B,H,W,1] (0 = no
    point) -> the 4 inverse depths [B,h,w] in fp32."""
    net = Net(w, dtype, quant)
    inv, _ = net.run(nchw(rgb.to(dtype)), nchw(lidar.to(dtype)))
    return [d[:, 0].float() for d in inv]
