"""ResNet depth and pose networks (monodepth2 style): counterpart of
``mindtheedge_tpu/models/resnet.py:19-221`` (reference
``networks/layers/resnet/*``, ``networks/depth/DepthResNet.py``,
``networks/pose/PoseResNet.py``).

NCHW inside, NHWC at ``forward``.  ``state_dict`` keys are the
reference's: the encoder is a torchvision-style ResNet under
``encoder.encoder`` (``conv1``, ``bn1``, ``layer{1..4}.{b}.conv1/bn1/...``,
``downsample.0/1``), the depth decoder's convs sit in the list
``decoder.decoder`` (upconvs 4,0 ... 0,1 then dispconvs 0..3), the pose
decoder's in ``decoder.net`` (squeeze, pose 0, 1, 2).  The classifier
``fc`` of torchvision's ResNet is not built; the ImageNet weights of the
reference's ``pt`` versions are not bundled.  ``RaySurfaceResNet`` adds the
ray-surface decoder under ``ray_surf``, laid out as the depth decoder
(``resnet.py:224-261``, reference ``RaySurfaceResNet.py``).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mindtheedge_tpu_torch.parallel import spatial


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5, ``resnet.py:19-27``):
    in training the batch statistics normalise and the running variance
    takes the *biased* batch variance (torch's own BatchNorm takes the
    unbiased one); in eval the running statistics normalise.

    Under ``space`` (a ``parallel.spatial.Space``) the training statistics
    cover the samples of every block, as ``ops/sparse.MaskedBatchNorm``'s
    do: the count and the per-channel sum are summed over the blocks, then
    the squared deviations from the global mean, both through the
    differentiable ``space_all_reduce``; the output is normalised by the
    global mean and biased variance through autograd, and the running
    statistics take them, equal on every block.  The sums are at least
    fp32.  ``parallel/mesh.make_sharded_train_step`` sets a ``space`` of
    every rank, one chunk of the batch each."""

    space = None

    def __init__(self, num_features):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.space is not None:
            return self._space_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _update(self, mean, var):
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)

    def _space_forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        count = xf.new_tensor([x.numel() // x.shape[1]])
        both = spatial.space_all_reduce(torch.cat([count, xf.sum((0, 2, 3))]), self.space)
        count, mean = both[0], both[1:] / both[0]
        centred = xf - mean[:, None, None]
        var = spatial.space_all_reduce((centred ** 2).sum((0, 2, 3)), self.space) / count
        self._update(mean, var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (centred * scale[:, None, None] + self.bias[:, None, None]).to(x.dtype)


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


def _downsample(cin, cout, stride):
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, stride), BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BatchNorm2d(planes)
        self.downsample = (_downsample(cin, planes, stride)
                           if stride != 1 or cin != planes else None)

    def forward(self, x):
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * 4
        self.conv1, self.bn1 = _conv(cin, planes, 1), BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), BatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, cout, 1), BatchNorm2d(cout)
        self.downsample = (_downsample(cin, cout, stride)
                           if stride != 1 or cin != cout else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn3(self.conv3(F.relu(self.bn2(self.conv2(y)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


RESNET_SPECS = {18: (BasicBlock, (2, 2, 2, 2)),
                34: (BasicBlock, (3, 4, 6, 3)),
                50: (Bottleneck, (3, 4, 6, 3))}


class _ResNet(nn.Module):
    """torchvision's ResNet trunk without the classifier."""

    def __init__(self, num_layers, in_channels):
        super().__init__()
        if num_layers not in RESNET_SPECS:
            raise ValueError(f'ResNet-{num_layers}: the port has 18, 34 and 50')
        block, layers = RESNET_SPECS[num_layers]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (n_blocks, planes, stride) in enumerate(
                zip(layers, (64, 128, 256, 512), (1, 2, 2, 2))):
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(cin, planes, stride if b == 0 else 1))
                cin = planes * block.expansion
            self.add_module(f'layer{stage + 1}', nn.Sequential(*blocks))


class ResnetEncoder(nn.Module):
    """Five feature maps (strides 2..32) of the input normalised by
    (x - 0.45) / 0.225 (``resnet.py:86-114``); the max-pool pads with -inf."""

    def __init__(self, num_layers=18, num_input_images=1):
        super().__init__()
        self.encoder = _ResNet(num_layers, 3 * num_input_images)
        chans = [64, 64, 128, 256, 512]
        self.num_ch_enc = chans if num_layers <= 34 else [64] + [c * 4 for c in chans[1:]]

    def forward(self, x):
        e = self.encoder
        x = F.relu(e.bn1(e.conv1((x - 0.45) / 0.225)))
        features = [x]
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = stage(x)
            features.append(x)
        return features


class Conv3x3Refl(nn.Module):
    """ReflectionPad(1) + 3x3 conv (``resnet.py:123-131``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode='reflect'))


class UpConv(nn.Module):
    """monodepth2's ``ConvBlock``: Conv3x3Refl + ELU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv3x3Refl(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


DEC_CHANNELS = (16, 32, 64, 128, 256)


class DepthDecoder(nn.Module):
    """monodepth2 depth decoder (``resnet.py:134-155``) -> sigmoid
    disparities at scales 0..3 (strides 1..8): one head a scale of
    ``scales``, behind the 10 upconvs in ``decoder``."""

    scales = (0, 1, 2, 3)
    activation = staticmethod(torch.sigmoid)

    def __init__(self, num_ch_enc, num_output_channels=1):
        super().__init__()
        convs = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else DEC_CHANNELS[i + 1]
            convs.append(UpConv(cin, DEC_CHANNELS[i]))
            cin = DEC_CHANNELS[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(UpConv(cin, DEC_CHANNELS[i]))
        convs += [Conv3x3Refl(DEC_CHANNELS[s], num_output_channels) for s in self.scales]
        self.decoder = nn.ModuleList(convs)

    def forward(self, features):
        """The heads' outputs, in the order of ``scales``."""
        x = features[-1]
        outs = {}
        for j, i in enumerate(range(4, -1, -1)):
            x = F.interpolate(self.decoder[2 * j](x), scale_factor=2, mode='nearest')
            if i > 0:
                x = torch.cat([x, features[i - 1]], 1)
            x = self.decoder[2 * j + 1](x)
            if i in self.scales:
                outs[i] = self.activation(self.decoder[10 + self.scales.index(i)](x))
        return [outs[s] for s in self.scales]


class RaySurfaceDecoder(DepthDecoder):
    """The ray-surface decoder (``resnet.py:224-244``, reference
    ``raysurface_decoder.py``): the depth decoder's upconvs and one 3-channel
    tanh head at scale 0."""

    scales = (0,)
    activation = staticmethod(torch.tanh)

    def __init__(self, num_ch_enc):
        super().__init__(num_ch_enc, num_output_channels=3)


def disp_to_depth(disp, min_depth=0.1, max_depth=100.0):
    """Sigmoid disparity -> scaled disparity (``resnet.py:158-162``)."""
    min_disp, max_disp = 1 / max_depth, 1 / min_depth
    return min_disp + (max_disp - min_disp) * disp


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


class DepthResNet(nn.Module):
    """monodepth2-style depth network (``resnet.py:165-181``), version
    'XY' with X the layers (18, 34, 50).  ``forward(rgb, input_depth=None,
    generator=None, rgb_edge=None)`` takes the task's call and ignores the
    LiDAR and ``rgb_edge``; training returns 4 inverse depths, eval scale 0
    alone."""

    def __init__(self, version='18'):
        super().__init__()
        self.encoder = ResnetEncoder(int(version[:2]))
        self.decoder = DepthDecoder(self.encoder.num_ch_enc)

    def _features(self, rgb):
        return self.encoder(rgb.permute(0, 3, 1, 2))

    def _inv_depths(self, features):
        inv_depths = [_nhwc(disp_to_depth(d)) for d in self.decoder(features)]
        return inv_depths if self.training else inv_depths[:1]

    def forward(self, rgb, input_depth=None, generator=None, rgb_edge=None):
        return {'inv_depths': self._inv_depths(self._features(rgb))}


class RaySurfaceResNet(DepthResNet):
    """ResNet + ray-surface decoder for generic (non-pinhole) cameras
    (``resnet.py:247-261``, reference ``RaySurfaceResNet.py:35-66``):
    :class:`DepthResNet`'s output plus ``'ray_surface'`` [B,H,W,3], a
    tanh per-pixel ray direction (not normalised), in training and at
    eval."""

    def __init__(self, version='18'):
        super().__init__(version)
        self.ray_surf = RaySurfaceDecoder(self.encoder.num_ch_enc)

    def forward(self, rgb, input_depth=None, generator=None, rgb_edge=None):
        features = self._features(rgb)
        return {'inv_depths': self._inv_depths(features),
                'ray_surface': _nhwc(self.ray_surf(features)[0])}


class PoseDecoder(nn.Module):
    """monodepth2 pose decoder (``resnet.py:184-202``): squeeze, two 3x3
    convs, a 1x1 head, the spatial mean, times 0.01."""

    def __init__(self, num_ch_enc, num_input_features=1, num_frames_to_predict_for=2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc[-1], 256, 1),
            nn.Conv2d(num_input_features * 256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1)])

    def forward(self, last_features):
        out = torch.cat([F.relu(self.net[0](f)) for f in last_features], 1)
        out = F.relu(self.net[2](F.relu(self.net[1](out))))
        out = self.net[3](out).mean((2, 3))
        return 0.01 * out.reshape(-1, self.num_frames, 6)


class PoseResNet(nn.Module):
    """ResNet pose network (``resnet.py:205-221``): per context image, the
    encoder on (image, context) stacked on channels, then the decoder ->
    [B, n_ctx, 6]."""

    def __init__(self, version='18'):
        super().__init__()
        self.encoder = ResnetEncoder(int(version[:2]), num_input_images=2)
        self.decoder = PoseDecoder(self.encoder.num_ch_enc, 1, 1)

    def forward(self, image, context):
        poses = []
        for ctx in context:
            x = torch.cat([image, ctx], -1).permute(0, 3, 1, 2)
            poses.append(self.decoder([self.encoder(x)[-1]])[:, 0])
        return torch.stack(poses, 1)


def init_weights(model, seed=0):
    """Seeded initialisation on the CPU: encoder convs Kaiming-normal
    (fan out), the other convs Xavier-uniform with zero bias, batch norms
    at one and zero (``resnet.py:16``; flax's default for the decoders)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if not isinstance(m, nn.Conv2d):
                continue
            if name.startswith('encoder.'):
                fan_out = m.out_channels * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
            else:
                fan_in = m.weight[0].numel()
                fan_out = m.out_channels * m.weight[0, 0].numel()
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
    return model
