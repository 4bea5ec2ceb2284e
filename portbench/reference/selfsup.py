"""Plain self-supervised training step of PackNet01 + PoseNet: the
benchmark's reference for the PackNet-SfM configuration.

Written from packnet-sfm (Guizilini et al., CVPR 2020):
``models/SelfSupModel.py``, ``networks/pose/PoseNet.py``,
``geometry/pose_utils.py`` (``euler2mat``, ``pose_vec2mat``),
``geometry/camera.py`` (``reconstruct``, ``project``),
``geometry/camera_utils.py`` (``view_synthesis``), ``utils/depth.py``
(``calc_smoothness``) and ``losses/multiview_photometric_loss.py``: SSIM
(``:16-55``), the warped SSIM + L1 loss with the min-reprojection over the
contexts and the unwarped contexts as automask candidates (``:227-255``),
the edge-aware smoothness (``:259-285``) and the whole loss (``:289-346``).
NCHW inside, as packnet-sfm; the batch comes NHWC, as the benchmark makes it.

The depth network is PackNet01 without the SAN: ``reference/packnet.py``'s
encoder and decoder over the weights dict, its convs' operands passed
through ``quant`` (the control's rounding); PoseNet, the warps and the
losses compute in fp32 and take no ``quant``.

Random draws follow the program's documented order on one generator of the
device: the lr-flip of the depth network's input, then (at a dropout rate
above 0) the 10 dropout masks in block order.

Departures from packnet-sfm:

* every scale's inverse depth is upsampled to full resolution before the
  loss (``upsample_depth_maps``, the configuration's setting), so images
  and intrinsics are never rescaled; the reference implements that case
  alone and refuses other shapes;
* the flip draws one Bernoulli for the whole batch (packnet-sfm flips per
  batch too, from Python's ``random``), on the device's generator;
* the per-pixel minimum is ``torch.min(dim).values`` as in packnet-sfm,
  which sends a tied minimum's gradient to one candidate (the program's
  ``torch.amin`` splits it); ties have measure zero on these images.
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference.packnet import Net, make_weights, nchw, nhwc
from portbench.reference.train import Adam, draw_keeps, flip

POSE_CHANNELS = (16, 32, 64, 128, 256, 256, 256)
POSE_KERNELS = (7, 5, 3, 3, 3, 3, 3)
POSE_GROUPS = 16
GN_EPS = 1e-5

# the configuration's loss settings (packnet-sfm's default_config.py)
LOSS = {'num_scales': 4, 'ssim_loss_weight': 0.85, 'C1': 1e-4, 'C2': 9e-4,
        'smooth_loss_weight': 0.001, 'automask_loss': True, 'padding_mode': 'zeros'}


# -- weights ------------------------------------------------------------------

def depth_weights(channels, seed, device):
    """PackNet01's weights: the encoder's and decoder's of
    ``reference/packnet.make_weights`` (which draws the SAN too)."""
    return {k: v for k, v in make_weights(channels, seed, device).items()
            if k.startswith(('encoder.', 'decoder.'))}


def pose_specs(contexts=2):
    """[(name, shape, init)] of PoseNet's ``state_dict``, in draw order."""
    ins = (3 * (1 + contexts),) + POSE_CHANNELS[:-1]
    specs = []
    for i, (cin, c, k) in enumerate(zip(ins, POSE_CHANNELS, POSE_KERNELS)):
        specs += [(f'conv{i + 1}.0.weight', (c, cin, k, k), 'conv'),
                  (f'conv{i + 1}.0.bias', (c,), 'zero'),
                  (f'conv{i + 1}.1.weight', (c,), 'one'),
                  (f'conv{i + 1}.1.bias', (c,), 'zero')]
    specs += [('pose_pred.weight', (6 * contexts, POSE_CHANNELS[-1], 1, 1), 'conv'),
              ('pose_pred.bias', (6 * contexts,), 'zero')]
    return specs


def pose_weights(seed, device, contexts=2):
    """PoseNet's weights drawn on ``device`` from ``seed``: xavier-uniform
    convs from one uniform draw, zero biases, GroupNorm at ones and zeros
    (packnet-sfm's ``init_weights``)."""
    specs = pose_specs(contexts)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s, init in specs if init == 'conv']
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    weights, at = {}, 0
    for name, shape, init in specs:
        if init == 'conv':
            n = math.prod(shape)
            rf = math.prod(shape[2:])
            b = math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))
            weights[name] = (flat[at:at + n].view(shape) * (2 * b) - b).clone()
            at += n
        else:
            weights[name] = torch.full(shape, 1.0 if init == 'one' else 0.0, device=device)
    return weights


# -- networks -----------------------------------------------------------------

def posenet(w, image, contexts):
    """PoseNet (``PoseNet.py:39-85``): NCHW target and contexts -> [B,n,6]."""
    x = torch.cat([image] + list(contexts), 1)
    for i, k in enumerate(POSE_KERNELS):
        p = f'conv{i + 1}'
        x = F.conv2d(x, w[f'{p}.0.weight'], w[f'{p}.0.bias'], stride=2, padding=(k - 1) // 2)
        x = F.relu(F.group_norm(x, POSE_GROUPS, w[f'{p}.1.weight'], w[f'{p}.1.bias'], GN_EPS))
    pose = F.conv2d(x, w['pose_pred.weight'], w['pose_pred.bias']).mean(3).mean(2)
    return 0.01 * pose.view(pose.shape[0], len(contexts), 6)


def euler2mat(angle):
    """[B,3] Euler angles -> [B,3,3], R = X @ Y @ Z (``pose_utils.py:9-38``)."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    zero, one = torch.zeros_like(z), torch.ones_like(z)
    zmat = torch.stack([torch.cos(z), -torch.sin(z), zero,
                        torch.sin(z), torch.cos(z), zero,
                        zero, zero, one], 1).view(-1, 3, 3)
    ymat = torch.stack([torch.cos(y), zero, torch.sin(y),
                        zero, one, zero,
                        -torch.sin(y), zero, torch.cos(y)], 1).view(-1, 3, 3)
    xmat = torch.stack([one, zero, zero,
                        zero, torch.cos(x), -torch.sin(x),
                        zero, torch.sin(x), torch.cos(x)], 1).view(-1, 3, 3)
    return xmat.bmm(ymat).bmm(zmat)


def pose_vec2mat(vec):
    """[B,6] (t, euler) -> [B,3,4] (``pose_utils.py:41-59``)."""
    return torch.cat([euler2mat(vec[:, 3:]), vec[:, :3].unsqueeze(-1)], 2)


# -- geometry -----------------------------------------------------------------

def inverse_intrinsics(K):
    """Closed-form pinhole K^-1 (``camera.py`` ``Kinv``)."""
    Kinv = K.clone()
    fx, fy, cx, cy = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]
    Kinv[:, 0, 0], Kinv[:, 1, 1] = 1.0 / fx, 1.0 / fy
    Kinv[:, 0, 2], Kinv[:, 1, 2] = -cx / fx, -cy / fy
    return Kinv


def reconstruct(depth, K):
    """[B,1,H,W] depth -> [B,3,H,W] points in the camera's frame."""
    b, _, h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=depth.dtype, device=depth.device),
                            torch.arange(w, dtype=depth.dtype, device=depth.device),
                            indexing='ij')
    grid = torch.stack([xs, ys, torch.ones_like(xs)], 0).view(1, 3, -1).expand(b, 3, h * w)
    return inverse_intrinsics(K).bmm(grid).view(b, 3, h, w) * depth


def project(X, K, pose):
    """[B,3,H,W] points moved by ``pose`` ([B,3,4] or [B,4,4]) and projected
    by ``K`` -> [B,H,W,2] sampling coordinates in [-1, 1]; Z at least 1e-5."""
    b, _, h, w = X.shape
    flat = pose[:, :3, :3].bmm(X.view(b, 3, -1)) + pose[:, :3, 3:]
    Xc = K.bmm(flat)
    Z = Xc[:, 2].clamp(min=1e-5)
    xn = 2 * (Xc[:, 0] / Z) / (w - 1) - 1.0
    yn = 2 * (Xc[:, 1] / Z) / (h - 1) - 1.0
    return torch.stack([xn, yn], -1).view(b, h, w, 2)


def view_synthesis(ref_image, depth, ref_K, K, pose, padding_mode='zeros'):
    """``ref_image`` [B,C,H,W] warped into the frame whose ``depth`` and
    ``K`` are given; ``pose`` maps that frame to the reference camera's
    (``camera_utils.py:28-60``)."""
    coords = project(reconstruct(depth, K), ref_K, pose)
    return F.grid_sample(ref_image, coords, mode='bilinear', padding_mode=padding_mode,
                         align_corners=True)


# -- losses -------------------------------------------------------------------

def ssim(x, y, C1, C2):
    """SSIM map over 3x3 windows, reflection padded (``:16-55``)."""
    pool = lambda t: F.avg_pool2d(t, 3, stride=1)
    x, y = F.pad(x, (1, 1, 1, 1), mode='reflect'), F.pad(y, (1, 1, 1, 1), mode='reflect')
    mu_x, mu_y = pool(x), pool(y)
    mu_xy, mu_x2, mu_y2 = mu_x * mu_y, mu_x.pow(2), mu_y.pow(2)
    sigma_x = pool(x.pow(2)) - mu_x2
    sigma_y = pool(y.pow(2)) - mu_y2
    sigma_xy = pool(x * y) - mu_xy
    v1 = 2 * sigma_xy + C2
    v2 = sigma_x + sigma_y + C2
    return ((2 * mu_xy + C1) * v1) / ((mu_x2 + mu_y2 + C1) * v2)


def photometric(t_est, image, ssim_loss_weight, C1, C2):
    """SSIM + L1 per pixel, [B,1,H,W] (``calc_photometric_loss``)."""
    l1 = (t_est - image).abs()
    s = torch.clamp((1.0 - ssim(t_est, image, C1, C2)) / 2.0, 0.0, 1.0)
    return ssim_loss_weight * s.mean(1, True) + (1 - ssim_loss_weight) * l1.mean(1, True)


def smoothness(inv_depths, image, num_scales):
    """The edge-aware smoothness of the mean-normalised inverse depths
    (``calc_smoothness``, ``:259-285``), before its weight."""
    grad_x = lambda t: t[:, :, :, :-1] - t[:, :, :, 1:]
    grad_y = lambda t: t[:, :, :-1, :] - t[:, :, 1:, :]
    wx = torch.exp(-grad_x(image).abs().mean(1, True))
    wy = torch.exp(-grad_y(image).abs().mean(1, True))
    total = 0.0
    for i in range(num_scales):
        d = inv_depths[i]
        d = d / d.mean([2, 3], True).clamp(min=1e-6)
        total = total + ((grad_x(d) * wx).abs().mean() + (grad_y(d) * wy).abs().mean()) / 2 ** i
    return total / num_scales


def multiview_loss(image, contexts, inv_depths, K, poses, num_scales, ssim_loss_weight, C1, C2,
                   smooth_loss_weight, automask_loss, padding_mode):
    """The photometric loss (``:289-346``), every scale at full resolution:
    per scale the minimum over the warped contexts (and, with
    ``automask_loss``, the unwarped ones) of SSIM + L1, averaged; plus the
    weighted smoothness.  NCHW; ``poses`` [B,3,4], target -> context."""
    h, w = image.shape[-2:]
    if any(tuple(d.shape[-2:]) != (h, w) for d in inv_depths[:num_scales]):
        raise ValueError('the reference takes every scale upsampled to full resolution')
    photo = lambda t: photometric(t, image, ssim_loss_weight, C1, C2)
    depths = [1.0 / inv_depths[i].clamp(min=1e-6) for i in range(num_scales)]
    per_scale = [[] for _ in range(num_scales)]
    for ref, pose in zip(contexts, poses):
        for i in range(num_scales):
            per_scale[i].append(photo(view_synthesis(ref, depths[i], K, K, pose, padding_mode)))
    if automask_loss:
        for ref in contexts:
            unwarped = photo(ref)
            for i in range(num_scales):
                per_scale[i].append(unwarped)
    loss = sum(torch.cat(c, 1).min(1, True).values.mean() for c in per_scale) / num_scales
    return loss + smooth_loss_weight * smoothness(inv_depths, image, num_scales)


# -- the step -----------------------------------------------------------------

def loss(wd, wp, batch, channels, gen, quant=None, rate=0.0, flip_prob=0.5, loss_rows=None,
         contexts=None, **photo):
    """One step's loss of the depth weights ``wd`` and pose weights ``wp``
    (fp32, with its graph) and the depth network's 4 inverse depths as it
    computed them (NCHW, on the flipped input).  Faults planted in the program's place: with
    ``loss_rows`` the networks see the whole batch and the loss only its
    first ``loss_rows`` rows; ``contexts`` keeps the loss's first contexts
    alone (the pose network still sees all); ``photo`` overrides
    :data:`LOSS` (``automask_loss=False``)."""
    params = dict(LOSS, **photo)
    dev = batch['rgb'].device
    b = batch['rgb'].shape[0]
    on = torch.rand((), device=dev, generator=gen) < flip_prob
    net = Net(wd, torch.float32, **({} if quant is None else {'quant': quant}))
    keeps = draw_keeps(b, channels, rate, gen, dev) if rate > 0 else None
    raw, _ = net.run(nchw(flip(batch['rgb'], on)), None, keeps, rate, train=True)
    h, w = batch['rgb'].shape[1:3]
    inv = [F.interpolate(nchw(flip(nhwc(d), on)), size=(h, w), mode='nearest') for d in raw]
    image = nchw(batch['rgb'])
    ctx_in = [nchw(c) for c in batch['rgb_context']]
    poses = [pose_vec2mat(v) for v in posenet(wp, image, ctx_in).unbind(1)]
    rows = slice(None, loss_rows)
    refs = [nchw(c)[rows] for c in batch['rgb_context_original']][:contexts]
    total = multiview_loss(nchw(batch['rgb_original'])[rows], refs, [d[rows] for d in inv],
                           batch['intrinsics'][rows].float(),
                           [p[rows] for p in poses][:contexts], **params)
    return total, raw


def run_steps(wd0, wp0, batches, channels, seed, lr_depth, lr_pose, quant=None, rate=0.0,
              flip_prob=0.5, loss_rows=None, contexts=None, **photo):
    """Train copies of ``wd0`` and ``wp0`` one step on each of ``batches`` ->
    (the loss of each step, {leaf: norm of its first gradient}, {leaf: norm
    of its change over the steps}, the first step's 4 inverse depths as
    the network computed them); the pose network's leaves are named
    ``pose.<name>``."""
    dev = batches[0]['rgb'].device
    wd = {k: v.clone().requires_grad_(True) for k, v in wd0.items()}
    wp = {k: v.clone().requires_grad_(True) for k, v in wp0.items()}
    names = list(wd) + [f'pose.{k}' for k in wp]
    leaves = list(wd.values()) + list(wp.values())
    start = list(wd0.values()) + list(wp0.values())
    opt_d, opt_p = Adam(list(wd.values()), lr_depth), Adam(list(wp.values()), lr_pose)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses, first, inv = [], None, None
    for batch in batches:
        total, raw = loss(wd, wp, batch, channels, gen, quant, rate, flip_prob, loss_rows,
                          contexts, **photo)
        grads = torch.autograd.grad(total, leaves)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in zip(names, grads)}
            inv = [d.detach() for d in raw]
        opt_d.step(grads[:len(wd)])
        opt_p.step(grads[len(wd):])
        losses.append(float(total.detach()))
    change = {k: float(torch.linalg.vector_norm((p.detach() - p0).double()))
              for k, p, p0 in zip(names, leaves, start)}
    return losses, first, change, inv
