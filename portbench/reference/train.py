"""Plain training step of the paper's model: the benchmark's reference.

``SemiSupEdgeModel`` as ``train_packnet_san_kitti_with_edges.yaml`` writes
it (MindTheEdge ``SemiSupEdgeModel.py``, ``losses/grad_loss.py``,
``losses/supervised_loss.py``): a Bernoulli lr-flip of the batch, the RGB
pass and the RGBD pass (the latter for its SAN statistics) with channel
dropout on the residual shortcuts, the sparse-silog loss at scale 0 and the
normal-aware GradLoss at 4 scales, the backward, and Adam.

Random draws follow the program's documented order on one generator of
the device: the flip, then each pass's 10 dropout masks in block order.
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference.packnet import NUM_BLOCKS, Net, nchw, nhwc

SOBEL3_V = ((-1., -2., -1.), (0., 0., 0.), (1., 2., 1.))
SOBEL3_H = ((-1., 0., 1.), (-2., 0., 2.), (-1., 0., 1.))
SOBEL3_LR = ((-2., -1., 0.), (-1., 0., 1.), (0., 1., 2.))
SOBEL3_RL = ((0., 1., 2.), (-1., 0., 1.), (-2., -1., 0.))


def dropout_widths(channels):
    """The shortcut widths of the 10 residual blocks, in order."""
    return [c for c, n in zip(channels[2:], NUM_BLOCKS) for _ in range(n)]


def draw_keeps(batch, channels, rate, gen, device):
    return [torch.rand(batch, c, 1, 1, device=device, generator=gen) >= rate
            for c in dropout_widths(channels)]


def flip(x, on):
    return torch.where(on, torch.flip(x, dims=(2,)), x)


def silog(pred_inv, gt_depth, ratio=10.0, ratio2=0.85):
    """Sparse scale-invariant log loss on inverse depth (pred + 1e-5)."""
    gt_inv = torch.where(gt_depth > 0, 1.0 / torch.clamp(gt_depth, min=1e-6), 0.0)
    mask = gt_inv > 0
    count = torch.clamp(mask.sum().float(), min=1.0)
    pred = pred_inv + 1e-5
    d = torch.log(torch.where(mask, pred, 1.0) * ratio) - torch.log(torch.where(mask, gt_inv, 1.0) * ratio)
    s1 = torch.where(mask, d ** 2, 0.0).sum() / count
    s2 = ratio2 * (torch.where(mask, d, 0.0).sum() / count) ** 2
    return torch.sqrt(torch.clamp(s1 - s2, min=0.0)) * ratio


def grad_loss(depth, gt_edge, normal, thresh=4.0, weight=10.0):
    """GradLoss with normals: the zero-padded Sobel-3 derivative along the
    normal's bucket, sigmoid(mag - thresh), class-balanced BCE."""
    kernels = torch.tensor((SOBEL3_V, SOBEL3_H, SOBEL3_LR, SOBEL3_RL),
                           dtype=depth.dtype, device=depth.device)[:, None]
    y = F.conv2d(nchw(depth), kernels, padding=1)
    x_v, x_h, x_lr, x_rl = (nhwc(y[:, i:i + 1]) for i in range(4))
    pi = math.pi
    rng = lambda lo, hi: (normal >= lo) & (normal < hi)
    mag = torch.abs(x_h)
    mag = torch.where(rng(-5 * pi / 8, -3 * pi / 8) | rng(3 * pi / 8, 5 * pi / 8), x_v.abs(), mag)
    mag = torch.where(rng(-7 * pi / 8, -5 * pi / 8) | rng(pi / 8, 3 * pi / 8), x_rl.abs(), mag)
    mag = torch.where(rng(-3 * pi / 8, -pi / 8) | rng(5 * pi / 8, 7 * pi / 8), x_lr.abs(), mag)
    prob = torch.sigmoid(mag - thresh)
    pos = -gt_edge * torch.log(prob + 0.001)
    neg = -(1.0 - gt_edge) * torch.log(1.0 - prob + 0.001)
    axes = (1, 2, 3)
    w_pos, w_neg = gt_edge.sum(axes), (1.0 - gt_edge).sum(axes)
    alpha = w_neg / torch.clamp(w_pos + w_neg, min=1e-12)
    per_sample = alpha * pos.sum(axes) + (1.0 - alpha) * neg.sum(axes)
    return weight * per_sample.sum() / gt_edge.numel()


EDGE_KEYS = (('edge', 'normal'), ('edge_1', 'normal_1'), ('edge_2', 'normal_2'),
             ('edge_3', 'normal_3'))


def loss(w, batch, channels, gen, dtype=torch.float32, quant=None, rate=0.5, flip_prob=0.5,
         loss_rows=None):
    """One step's loss of the weights dict ``w``; running statistics are
    updated in ``w``.  Returns the loss (fp32, with its graph).  With
    ``loss_rows`` (a planted fault) the passes see the whole batch and the
    losses only its first ``loss_rows`` rows."""
    dev = batch['rgb'].device
    b = batch['rgb'].shape[0]
    on = torch.rand((), device=dev, generator=gen) < flip_prob
    rgb = nchw(flip(batch['rgb'], on)).to(dtype)
    lidar = nchw(flip(batch['input_depth'], on)).to(dtype)
    kwargs = {} if quant is None else {'quant': quant}
    net = Net(w, dtype, **kwargs)
    keeps = draw_keeps(b, channels, rate, gen, dev)
    inv, _ = net.run(rgb, None, keeps, rate, train=True)
    keeps = draw_keeps(b, channels, rate, gen, dev)
    with torch.no_grad():       # the RGBD pass: no loss reads it
        net.run(rgb, lidar, keeps, rate, train=True)
    inv = [flip(nhwc(d).float(), on)[:loss_rows] for d in inv]
    batch = {k: v[:loss_rows] for k, v in batch.items()}
    sup = silog(inv[0], batch['depth'])
    edge = sum(grad_loss(1.0 / torch.clamp(inv[s], min=1e-6), batch[e], batch[n])
               for s, (e, n) in enumerate(EDGE_KEYS)) / 4.0
    return sup + edge


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8, no weight decay) over ``params``."""

    def __init__(self, params, lr):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + eps))


def is_stat(name):
    return '.running_' in name or name.endswith('num_batches_tracked')


def run_steps(w0, batches, channels, seed, lr, dtype=torch.float32, quant=None,
              rate=0.5, flip_prob=0.5, loss_rows=None):
    """Train a copy of ``w0`` one step on each of ``batches`` -> (the loss of
    each step, {leaf: norm of its first gradient}, {leaf: norm of its change
    over the steps}, {running statistic: norm of its change})."""
    dev = batches[0]['rgb'].device
    w = {k: v.clone() for k, v in w0.items()}
    names = [k for k in w if not is_stat(k)]
    for k in names:
        w[k].requires_grad_(True)
    opt = Adam([w[k] for k in names], lr)
    gen = torch.Generator(device=dev).manual_seed(seed)
    losses, first = [], None
    for batch in batches:
        total = loss(w, batch, channels, gen, dtype, quant, rate, flip_prob, loss_rows)
        grads = torch.autograd.grad(total, [w[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(w[k]) if g is None else g for k, g in zip(names, grads)]
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g.double())) for k, g in zip(names, grads)}
        opt.step(grads)
        losses.append(float(total.detach()))
    change = {k: float(torch.linalg.vector_norm((w[k].detach() - w0[k]).double()))
              for k in names}
    stats = {k: float(torch.linalg.vector_norm((w[k] - w0[k]).double()))
             for k in w if is_stat(k) and w[k].is_floating_point()}
    return losses, first, change, stats
