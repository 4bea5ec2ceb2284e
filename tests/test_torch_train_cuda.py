"""One training step on the card against the same step on the CPU, for the
paper's ``SemiSupEdgeModel`` and for DEE, completion and self-supervised
training; the photometric loss on the card against the CPU (gradients within 3e-4
of their tensor's largest, ``photometric_card_vs_cpu``); a checkpoint
round trip on the card; a bf16 step on the card against the CPU within
``BAND`` times the CPU's own bf16-vs-fp32 gap (``bf16_card_vs_cpu``); a
step with ``remat`` True and ``'conv'`` against the step without it on the
card (``remat_vs_plain``); the helpers ``chip_smoke.py`` shares, among them
the writer of a synthetic KITTI raw tree (``write_kitti_tree``).

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_cuda.py

Without a CUDA device the card tests skip.  Both sides start from the same
seeded weights and batch, at dropout 0 and ``flip_lr_prob`` 0, TF32 off;
the card's convs are cuDNN's, the CPU's ATen's, so they round differently.
Tolerances: the loss rtol 1e-4; each parameter's gradient within 1e-4 of
that tensor's largest |gradient| (for the self-supervised task, or
within 1e-6 of the network's largest, whichever is more, as
tests/test_torch_train_tasks.py holds a gradient that cancels); the parameters after the Adam
step within lr * 1e-2; running statistics rtol 1e-4.  Two kinds of values
are rounding noise on both sides and are held to what noise allows
(``compare_states``): gradient tensors that vanish analytically, and the
Adam step of an element whose gradient lies inside that noise.
"""

import os

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.geometry.camera import view_synthesis
from mindtheedge_tpu_torch.geometry.pose import pose_vec2mat
from mindtheedge_tpu_torch.losses.photometric import multiview_photometric_loss
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.training.checkpoint import (
    load_checkpoint, restore_train_state, save_checkpoint)
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step

LR = 1e-4
ADAM_EPS = 1e-8     # torch.optim.Adam's default
GRAD_RTOL = 1e-4    # card vs CPU: of each gradient tensor's largest |value|


def train_config(channels=(16,) * 6, dropout=0.0, flip_lr_prob=0.0, seed=0):
    """The paper's training task (``SemiSupEdgeModel``, sparse-silog, GradLoss
    at 4 scales with normals, edge weight 10), built in code."""
    cfg = get_cfg_defaults()
    cfg.arch.seed = seed
    cfg.model.name = 'SemiSupEdgeModel'
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.version = '1A'
    cfg.model.depth_net.channels = tuple(channels)
    cfg.model.depth_net.dropout = dropout
    cfg.model.loss.supervised_method = 'sparse-silog'
    cfg.model.loss.supervised_num_scales = 1
    cfg.model.loss.supervised_loss_weight = 1.0
    cfg.model.loss.edges_depth_edge_loss_all_scales = True
    cfg.model.loss.upsample_depth_maps = False
    cfg.model.loss.flip_lr_prob = flip_lr_prob
    cfg.model.optimizer.depth.lr = LR
    cfg.edges.train_depth_edges = True
    cfg.edges.depth_edges_loss_weight = 10.0
    return cfg


def synthetic_batch(rng, b, h, w):
    """A numpy batch: RGB, a blocky depth scene, its GT 90 % and LiDAR 95 %
    sparse, its edges and normals (angles) at the 4 scales."""
    depth = np.full((b, h, w, 1), 30.0, np.float32)
    for i in range(b):
        for _ in range(3):
            y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
            depth[i, y:y + rng.randint(8, h // 2), x:x + rng.randint(8, w // 2)] = \
                rng.uniform(5, 25)
    batch = {'rgb': rng.rand(b, h, w, 3).astype(np.float32)}
    batch['depth'] = np.where(rng.rand(b, h, w, 1) < 0.9, 0.0, depth).astype(np.float32)
    batch['input_depth'] = np.where(rng.rand(b, h, w, 1) < 0.95, 0.0,
                                    depth).astype(np.float32)
    for s, key in enumerate(('', '_1', '_2', '_3')):
        d = depth[:, ::2 ** s, ::2 ** s]
        edge = (np.diff(d, axis=2, append=d[:, :, -1:]) != 0) | \
            (np.diff(d, axis=1, append=d[:, -1:]) != 0)
        batch['edge' + key] = edge.astype(np.float32)
        batch['normal' + key] = ((rng.rand(*d.shape) * 2 - 1) * np.pi).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def named_parameters(state):
    """(name, parameter) of the depth network, then of the pose network,
    the names prefixed ``depth.`` / ``pose.``."""
    return [(f'{tag}.{n}', p) for tag, net in (('depth', state.net), ('pose', state.pose_net))
            if net is not None for n, p in net.named_parameters()]


def state_dicts(state):
    return {f'{tag}.{k}': v for tag, net in (('depth', state.net), ('pose', state.pose_net))
            if net is not None for k, v in net.state_dict().items()}


def one_step(task, batch):
    """A fresh train state over the task's networks, one step -> (state,
    metrics, parameters and buffers before the step)."""
    state = create_train_state(task.config, task.depth_net, pose_net=task.pose_net)
    before = {k: v.detach().clone() for k, v in state_dicts(state).items()}
    metrics = make_train_step(task)(state, batch, torch.Generator(task.device))
    return state, metrics, before


def compare_states(card, host, before, grad_rtol=GRAD_RTOL, noise_floor=0.0):
    """Card vs CPU after one step -> the worst ratios found.  Gradients:
    each tensor within ``grad_rtol`` of its largest |gradient| (or
    ``noise_floor`` of its network's largest, if more); a tensor whose
    largest |gradient| on the CPU is below 1e-5 of its network's vanishes
    analytically (with (16,)*6 channels the GroupNorm has one channel per
    group, so the conv bias before it gets zero; the SAN ladder feeds no
    loss of some tasks) and is held within 1e-5 of the network's.
    Parameters after the step: within lr * 1e-2, except where the CPU's
    |gradient| lies inside that noise (Adam's first step is then +-lr on
    either side) or so near Adam's eps (1e-8) that an error of the
    gradient's tolerance moves the step lr*g/(|g|+eps) by more than
    lr * 1e-2 (the pose network's gradients reach down to ~1e-8); there
    |step| <= the group's lr, give or take two ulps of the parameter."""
    grads_c = {n: p.grad.cpu() for n, p in named_parameters(card)}
    grads_h = {n: p.grad for n, p in named_parameters(host)}
    tops = {tag: max(float(g.abs().max()) for n, g in grads_h.items()
                     if n.startswith(tag + '.')) for tag in {n.split('.')[0] for n in grads_h}}
    lrs = {'depth': LR, 'pose': host.optimizer.param_groups[-1]['lr']}
    worst_grad = worst_param = 0.0
    after_c = {k: v.cpu() for k, v in state_dicts(card).items()}
    after_h = state_dicts(host)
    for name, gh in grads_h.items():
        tag = name.split('.')[0]
        top, lr = tops[tag], lrs[tag]
        scale = float(gh.abs().max())
        vanishing = scale < 1e-5 * top
        tol = 1e-5 * top if vanishing else max(grad_rtol * scale, noise_floor * top)
        err = float((grads_c[name] - gh).abs().max())
        assert err <= tol, f'gradient {name}: {err} > {tol}'
        if not vanishing:
            worst_grad = max(worst_grad, err / scale)
        # inside the noise: |g| within the tolerance, or so near Adam's eps
        # that a gradient error of ``tol`` moves the step lr*g/(|g|+eps) by
        # more than lr * 1e-2 (derivative lr*eps/(|g|+eps)^2)
        noise = (torch.ones_like(gh, dtype=torch.bool) if vanishing
                 else (gh.abs() <= grad_rtol * scale)
                 | ((gh.abs() + ADAM_EPS) ** 2 < 100 * tol * ADAM_EPS))
        off = (after_c[name] - after_h[name]).abs()
        assert bool((off[~noise] <= lr * 1e-2).all()), f'parameter {name}'
        worst_param = max(worst_param, float(off[~noise].max()) / lr if (~noise).any() else 0.0)
        step = (after_c[name] - before[name]).abs()
        ulps = 2 * torch.finfo(torch.float32).eps * float(before[name].abs().max())
        assert float(step.max()) <= lr * 1.001 + ulps, \
            f'parameter {name} moved by {float(step.max())}'
    for name, t in after_h.items():
        if name.endswith(('running_mean', 'running_var')):
            torch.testing.assert_close(after_c[name], t, rtol=1e-4, atol=1e-6,
                                       msg=lambda m, name=name: f'{name}: {m}')
    return {'grad_vs_max': worst_grad, 'param_vs_lr': worst_param}


def smooth_images(rng, n, b, h, w):
    """``n`` [b,h,w,3] images of smooth random texture: noise on an 8-pixel
    grid, upsampled and blurred 6 times by the binomial [1,4,6,4,1]/16.  On
    white noise the bilinear sampler's derivative jumps by O(1) at every
    integer coordinate, where two computations may round to either side
    (the pose gradients then differed from JAX's by up to 1.7e-3 of their
    largest, measured); here the jumps are second differences of a smooth
    image (7.5e-5)."""
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    out = []
    for _ in range(n):
        x = rng.rand(b, h // 8 + 4, w // 8 + 4, 3).astype(np.float32)
        x = np.repeat(np.repeat(x, 8, 1), 8, 2)
        for _ in range(6):
            for axis in (1, 2):
                n_ax = x.shape[axis] - 4
                x = sum(k[i] * np.take(x, range(i, i + n_ax), axis) for i in range(5))
        out.append(np.ascontiguousarray(x[:, 8:8 + h, 8:8 + w]))
    return out


def kitti_intrinsics(b, h, w):
    """[b,3,3] pinhole intrinsics in the KITTI proportions (fx ~ 0.58 w)."""
    k = np.array([[0.58 * w, 0.0, 0.5 * w - 0.3],
                  [0.0, 1.92 * h, 0.5 * h + 0.2],
                  [0.0, 0.0, 1.0]], np.float32)
    return np.stack([k * np.array([[1 + 0.05 * i], [1], [1]], np.float32) for i in range(b)])


def selfsup_batch(rng, b, h, w):
    """``synthetic_batch`` plus two context images (white noise, as the
    networks' inputs), the unaugmented target and contexts (smooth
    texture, as the photometric loss's images) and the intrinsics."""
    batch = synthetic_batch(rng, b, h, w)
    batch['rgb_context'] = [torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32))
                            for _ in range(2)]
    original, *context = smooth_images(rng, 3, b, h, w)
    batch['rgb_original'] = torch.from_numpy(original)
    batch['rgb_context_original'] = [torch.from_numpy(c) for c in context]
    batch['intrinsics'] = torch.from_numpy(kitti_intrinsics(b, h, w))
    return batch


def set_pose_head_bias(pose_net, rng):
    """A pose head bias that moves pixels by a few pixels: translations
    ~0.2 m and rotations ~0.02 rad after the head's x0.01."""
    head = pose_net.pose_pred if hasattr(pose_net, 'pose_pred') else pose_net.decoder.net[3]
    n = head.bias.numel() // 6
    with torch.no_grad():
        head.bias.copy_(torch.from_numpy(np.tile(np.concatenate(
            [rng.uniform(-30, 30, 3), rng.uniform(-2, 2, 3)]), n).astype(np.float32)))


def task_config(name, weight=1.0, pose_net='', channels=(16,) * 6):
    """``train_config`` as ``name`` at ``supervised_loss_weight`` ``weight``
    with the pose network ``pose_net`` (one back and one forward context)."""
    cfg = train_config(channels)
    cfg.model.name = name
    cfg.model.loss.supervised_loss_weight = weight
    cfg.model.pose_net.name = pose_net
    cfg.model.optimizer.pose.lr = LR / 2
    return cfg


TASKS = {   # the tasks of phase 8a: (config, batch, noise floor)
    'EdgeEstimationLIDARModel': (lambda: task_config('EdgeEstimationLIDARModel'),
                                 synthetic_batch, 0.0),
    'SemiSupEdgeCompletionModel': (lambda: task_config('SemiSupEdgeCompletionModel'),
                                   synthetic_batch, 0.0),
    'SemiSupModel': (lambda: task_config('SemiSupModel', 0.5, 'PoseNet'), selfsup_batch, 1e-6),
}


def train_step_card_vs_cpu(dev, channels=(16,) * 6, shape=(2, 64, 96), task=None, spec=None):
    """One ``train_step`` of the same seeded task and batch on ``dev`` and
    on the CPU -> (the CPU's and the card's loss, the worst ratios).
    ``task`` None is the paper's ``SemiSupEdgeModel``, else a key of
    ``TASKS``; ``spec`` a (config, batch, noise floor) triple as theirs."""
    if task is None and spec is None:
        cfg, make_batch, floor = train_config(channels), synthetic_batch, 0.0
    else:
        make_cfg, make_batch, floor = spec or TASKS[task]
        cfg = make_cfg()
    host_task = build_task(cfg, device='cpu')
    card_task = build_task(cfg, device=dev)
    if host_task.pose_net is not None:
        set_pose_head_bias(host_task.pose_net, np.random.RandomState(1))
        card_task.pose_net.load_state_dict(host_task.pose_net.state_dict())
    card_task.depth_net.load_state_dict(host_task.depth_net.state_dict())
    batch = make_batch(np.random.RandomState(0), *shape)
    to_dev = lambda v: [x.to(dev) for x in v] if isinstance(v, list) else v.to(dev)
    card, m_card, _ = one_step(card_task, {k: to_dev(v) for k, v in batch.items()})
    host, m_host, before = one_step(host_task, batch)
    assert card.step == host.step == 1
    loss_h, loss_c = float(m_host['loss']), float(m_card['loss'])
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h), (loss_c, loss_h)
    for k in m_host:
        np.testing.assert_allclose(float(m_card[k]), float(m_host[k]), rtol=1e-4, err_msg=k)
    return loss_h, loss_c, compare_states(card, host, before, noise_floor=floor)


def smooth_inverse_depths(rng, b, h, w):
    """4 scales of a smooth inverse depth in [0.05, 0.5]: one channel of
    ``smooth_images``, subsampled by 2 per scale."""
    t = smooth_images(rng, 1, b, h, w)[0][..., :1]
    return [np.ascontiguousarray(0.05 + 0.45 * t[:, ::2 ** s, ::2 ** s]) for s in range(4)]


def photometric_gaps(dev, shape=(2, 64, 96), smooth_depth=False, part='loss'):
    """``multiview_photometric_loss`` (4 scales, two contexts, automask) on
    the card and on the CPU from the same inputs, its gradients with respect
    to the inverse depths and the pose vectors -> {padding mode: the worst
    gradient error over its tensor's largest |gradient|}.  The values agree
    within rtol 1e-5.  Each pixel's inverse depth is drawn uniformly, so
    warped coordinates land anywhere, near integers too, where the bilinear
    sampler's derivative jumps; ``smooth_depth`` draws a smooth one
    instead.  ``part``: 'loss' the photometric loss, 'mean' the same with
    the contexts reduced by their mean instead of their minimum, 'warp' a
    fixed random weighting of the warped context images at scale 0 (no
    SSIM, L1 or reduction)."""
    b, h, w = shape
    rng = np.random.RandomState(2)
    image, *context = smooth_images(rng, 3, b, h, w)
    inv = smooth_inverse_depths(rng, b, h, w) if smooth_depth else [
        rng.uniform(0.05, 0.5, (b, h >> s, w >> s, 1)).astype(np.float32) for s in range(4)]
    vecs = np.concatenate([rng.uniform(-0.3, 0.3, (b, 2, 3)),
                           rng.uniform(-0.03, 0.03, (b, 2, 3))], -1).astype(np.float32)
    K = kitti_intrinsics(b, h, w)
    weights = rng.randn(b, h, w, 3).astype(np.float32)
    worst = {}
    for padding_mode in ('zeros', 'border'):
        sides = []
        for device in ('cpu', dev):
            t = lambda a: torch.from_numpy(np.array(a)).to(device)
            inv_t = [t(d).requires_grad_() for d in inv]
            vec_t = t(vecs).requires_grad_()
            poses = [pose_vec2mat(vec_t[:, i]) for i in range(2)]
            if part == 'warp':
                loss = sum((view_synthesis(t(c), 1.0 / inv_t[0], t(K), t(K), p,
                                           padding_mode=padding_mode) * t(weights)).sum()
                           for c, p in zip(context, poses))
            else:
                loss, _ = multiview_photometric_loss(
                    t(image), [t(c) for c in context], inv_t, t(K), t(K), poses,
                    padding_mode=padding_mode,
                    photometric_reduce_op='min' if part == 'loss' else 'mean')
            loss.backward()
            grads = [x.grad for x in inv_t + [vec_t] if x.grad is not None]
            sides.append((float(loss.detach()), [g.cpu() for g in grads]))
        (loss_h, grads_h), (loss_c, grads_c) = sides
        assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h), (loss_c, loss_h)
        worst[padding_mode] = max(float((gc - gh).abs().max()) / float(gh.abs().max())
                                  for gh, gc in zip(grads_h, grads_c))
    return worst


PHOTOMETRIC_BOUND = 3e-4


def photometric_card_vs_cpu(dev, shape=(2, 64, 96)):
    """``photometric_gaps``, zeros and border padding, held to
    ``PHOTOMETRIC_BOUND`` of each tensor's largest gradient -> the worst."""
    worst = photometric_gaps(dev, shape)
    assert max(worst.values()) <= PHOTOMETRIC_BOUND, worst
    return max(worst.values())


def photometric_gap_causes(dev):
    """The card-vs-CPU gradient gap of the photometric loss by cause ->
    {case: {padding mode: worst}}: uniform against smooth inverse depths;
    the loss, the loss with a mean in place of the min, and the warp alone
    (``photometric_gaps``); cuDNN on and off (zeros padding with
    ``align_corners=True`` makes ``F.grid_sample`` take cuDNN's sampler on
    the card, border padding ATen's)."""
    cases = {}
    for smooth in (False, True):
        for part in ('loss', 'mean', 'warp'):
            for cudnn in (True, False):
                with torch.backends.cudnn.flags(enabled=cudnn):
                    cases[(f'{"smooth" if smooth else "uniform"} depth, {part}, '
                           f'cudnn {"on" if cudnn else "off"}')] = photometric_gaps(
                        dev, smooth_depth=smooth, part=part)
    return cases


# -- a synthetic KITTI raw tree (the layout of tests/test_kitti_dataset.py:33-71)
#
#     <root>/<date>/calib_{cam_to_cam,velo_to_cam,imu_to_velo}.txt
#     <root>/<date>/<drive>/image_02/data/<frame>.png     RGB
#     <root>/<date>/<drive>/oxts/data/<frame>.txt         GPS/IMU packet
#     <root>/KITTI_depth/train/<drive>/proj_depth/groundtruth/image_02/<frame>.png
#     <root>/KITTI_depth/data_depth_velodyne/train/<drive>/proj_depth/velodyne_raw/image_02/<frame>.png
#     <root>/split.txt                                     one image path a line

DATE = '2011_09_26'
DRIVE = '2011_09_26_drive_0001_sync'


def _texture(rng, h, w):
    """A smooth random [h, w, 3] texture in [0, 255]: noise on an 8-pixel
    grid, upsampled and box-blurred."""
    x = rng.rand(h // 8 + 3, w // 8 + 3, 3)
    x = np.repeat(np.repeat(x, 8, 0), 8, 1)
    for _ in range(4):
        x = (x[:-2] + x[1:-1] + x[2:]) / 3
        x = (x[:, :-2] + x[:, 1:-1] + x[:, 2:]) / 3
    return 255 * x[:h, :w]


def write_kitti_tree(root, n_frames=6, h=8, w=16, seed=0, no_gt=(4,)):
    """Write the tree under ``root`` -> the split file's path.  The frames
    pan across one smooth random texture by 2 pixels a frame; the depth
    maps are uint16 PNGs of metres x 256 (0 = no point), 30 % of the
    pixels for the ground truth, 5 % for the LiDAR; the frames listed in
    ``no_gt`` have no ground truth."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    drive_dir = os.path.join(root, DATE, DRIVE)
    depth_root = os.path.join(root, 'KITTI_depth')
    dirs = {
        'rgb': os.path.join(drive_dir, 'image_02', 'data'),
        'oxts': os.path.join(drive_dir, 'oxts', 'data'),
        'gt': os.path.join(depth_root, 'train', DRIVE, 'proj_depth', 'groundtruth', 'image_02'),
        'lidar': os.path.join(depth_root, 'data_depth_velodyne', 'train', DRIVE,
                              'proj_depth', 'velodyne_raw', 'image_02'),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    texture = _texture(rng, h, w + 2 * n_frames)
    depth = np.full((h, w), 20.0)
    depth[h // 4:3 * h // 4, w // 4:w // 2] = 8.0
    for i in range(n_frames):
        name = f'{i:010d}'
        rgb = texture[:, 2 * i:2 * i + w].astype(np.uint8)
        Image.fromarray(np.ascontiguousarray(rgb)).save(os.path.join(dirs['rgb'], name + '.png'))
        # lat lon alt roll pitch yaw, padded to the 30 fields of a packet
        vals = [49.0 + i * 1e-5, 8.4 + i * 1e-5, 110.0, 0.01, -0.02,
                0.5 + i * 0.01] + [0.0] * 24
        with open(os.path.join(dirs['oxts'], name + '.txt'), 'w') as f:
            f.write(' '.join(map(str, vals)))
        for kind, share in (('gt', 0.3), ('lidar', 0.05)):
            if kind == 'gt' and i in no_gt:
                continue
            d = np.where(rng.rand(h, w) < share, depth + i * 0.1, 0.0)
            Image.fromarray((d * 256).astype(np.uint16)).save(
                os.path.join(dirs[kind], name + '.png'))
    P = ' '.join(map(str, [0.58 * w, 0, w / 2, 0.4, 0, 1.92 * h, h / 2, 0.1,
                           0, 0, 1.0, 0.01]))
    R9 = ' '.join(map(str, np.eye(3).ravel()))
    date_dir = os.path.join(root, DATE)
    with open(os.path.join(date_dir, 'calib_cam_to_cam.txt'), 'w') as f:
        f.write(f'P_rect_02: {P}\nP_rect_03: {P}\nR_rect_00: {R9}\n')
    with open(os.path.join(date_dir, 'calib_velo_to_cam.txt'), 'w') as f:
        f.write(f'R: {R9}\nT: 0.1 0.2 0.3\n')
    with open(os.path.join(date_dir, 'calib_imu_to_velo.txt'), 'w') as f:
        f.write(f'R: {R9}\nT: 0.0 0.0 0.0\n')
    split = os.path.join(root, 'split.txt')
    with open(split, 'w') as f:
        f.write(''.join(f'{DATE}/{DRIVE}/image_02/data/{i:010d}.png\n'
                        for i in range(n_frames)))
    return split


BAND = 2.0     # bf16 vs bf16 may differ by this times bf16 vs fp32


def step_outcome(cfg, batch, device, seed=7, make_step=make_train_step):
    """One step made by ``make_step`` (``train_step`` by default) of the
    task of ``cfg`` from its seeded weights, the generator seeded with
    ``seed`` -> (loss, gradients, the depth network's state dict after the
    step, the generator's state)."""
    task = build_task(cfg, device=device)
    state = create_train_state(cfg, task.depth_net)
    to_dev = lambda v: [x.to(device) for x in v] if isinstance(v, list) else v.to(device)
    gen = torch.Generator(device).manual_seed(seed)
    metrics = make_step(task)(state, {k: to_dev(v) for k, v in batch.items()}, gen)
    return (float(metrics['loss']),
            {n: p.grad.detach().cpu().clone() for n, p in task.depth_net.named_parameters()},
            {k: v.cpu().clone() for k, v in task.depth_net.state_dict().items()},
            gen.get_state())


def tensor_errs(got, want, ref):
    """Each tensor's largest |got - want| over its largest |want| ->
    (median, max) over the tensors whose largest |value| in ``ref`` is above
    1e-5 of the largest there: below it a gradient vanishes analytically (a
    conv bias in front of a one-channel GroupNorm group) and holds rounding
    noise alone, bf16's far above 1e-5."""
    top = max(float(g.abs().max()) for g in ref.values())
    errs = [float((got[n].float() - g.float()).abs().max()) / float(g.abs().max())
            for n, g in want.items() if float(ref[n].abs().max()) > 1e-5 * top]
    return float(np.median(errs)), max(errs)


def outcome_gaps(got, want, fp32=None):
    """How far one step's outcome lies from another's -> {'loss': relative
    error, 'grad': (median, max) over the gradient tensors of the tensor's
    largest error over its largest |value|, 'stats': (median, max) relative
    error of the running statistics, 'counts': whether
    ``num_batches_tracked`` are equal, 'generator': whether the generators'
    states are}.  A gradient tensor that vanishes in ``fp32`` (an fp32
    outcome, else ``want``) is left out (:func:`tensor_errs`)."""
    keys = [k for k in want[2] if k.endswith(('running_mean', 'running_var'))]
    stats = torch.cat([((got[2][k] - want[2][k]).abs() / want[2][k].abs().clamp_min(1e-30)
                        ).ravel() for k in keys]).double().numpy()
    return {'loss': abs(got[0] - want[0]) / abs(want[0]),
            'grad': tensor_errs(got[1], want[1], (fp32 or want)[1]),
            'stats': (float(np.median(stats)), float(stats.max())),
            'counts': all(torch.equal(got[2][k], v) for k, v in want[2].items()
                          if k.endswith('num_batches_tracked')),
            'generator': torch.equal(got[3].cpu(), want[3].cpu())}


def bf16_card_vs_cpu(dev, shape=(2, 64, 96)):
    """One bf16 ``train_step`` of the paper's task (dropout and flip off)
    on the card against the same on the CPU, held to ``BAND`` times the
    CPU's own bf16-vs-fp32 gap in the loss, the gradients and the running
    statistics (median and max) -> (card-vs-CPU gaps, the CPU's gaps)."""
    cfg32 = train_config()
    cfg16 = cfg32.clone()
    cfg16.arch.precision = 'bfloat16'
    batch = synthetic_batch(np.random.RandomState(0), *shape)
    cpu16, cpu32 = step_outcome(cfg16, batch, 'cpu'), step_outcome(cfg32, batch, 'cpu')
    ref = outcome_gaps(cpu16, cpu32)
    got = outcome_gaps(step_outcome(cfg16, batch, dev), cpu16, fp32=cpu32)
    assert got['counts'] and got['loss'] <= BAND * ref['loss'], (got, ref)
    for key in ('grad', 'stats'):
        assert all(g <= BAND * r for g, r in zip(got[key], ref[key])), (key, got, ref)
    return got, ref


def remat_config(remat, channels=(16,) * 6, task='SemiSupEdgeCompletionModel'):
    """The training config with dropout 0.5 and flip 0.5 on, as ``task``
    (whose loss reads the RGBD pass, so its backward reruns the SAN)."""
    cfg = train_config(channels, dropout=0.5, flip_lr_prob=0.5)
    cfg.model.name = task
    cfg.model.depth_net.remat = remat
    return cfg


def variants_vs_plain(dev, cfg, variants, batch):
    """One plain ``train_step`` of ``cfg`` and one step of each variant
    (``{label: (config, make_step)}``) from the same weights, batch and
    generator seed on ``dev``; the plain step twice, for the run-to-run
    noise of the card's reductions -> {label: gaps against the plain
    step}, the bound, the noise.  Each holds the same draws (generator
    state, ``num_batches_tracked``) and its loss, gradients and running
    statistics within the bound: 4 times the noise's worst, and at least
    ``GRAD_RTOL``, the gradient tolerance of the card-vs-CPU step.  (One
    pair of runs gauges the noise loosely: the step without remat measured
    3.3e-6 against itself, then 3.2e-5 against the remat step, on one
    card; on the CPU the two are bit-equal, tests/test_torch_remat.py.)"""
    plain = step_outcome(cfg, batch, dev)
    noise = outcome_gaps(step_outcome(cfg, batch, dev), plain)
    bound = max(4 * max(noise['loss'], *noise['grad'], *noise['stats']), GRAD_RTOL)
    gaps = {}
    for label, (variant, make_step) in variants.items():
        gaps[label] = g = outcome_gaps(step_outcome(variant, batch, dev, make_step=make_step),
                                       plain)
        assert g['counts'] and g['generator'], \
            f'{label!r}: other dropout draws or statistics counts'
        worst = max(g['loss'], *g['grad'], *g['stats'])
        assert worst <= bound, f'{label!r}: {g} beyond {bound:.3e}'
    return gaps, bound, noise


def remat_vs_plain(dev, configs, batch):
    """:func:`variants_vs_plain` of ``configs`` ({remat: config}, False,
    the plain step, among them)."""
    return variants_vs_plain(dev, configs[False],
                             {r: (c, make_train_step) for r, c in configs.items()
                              if r is not False}, batch)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda_card):
    train_step_card_vs_cpu(cuda_card)


@pytest.mark.cuda
@pytest.mark.parametrize('task', list(TASKS))
def test_new_tasks_train_step_card_matches_cpu(cuda_card, task):
    train_step_card_vs_cpu(cuda_card, task=task)


@pytest.mark.cuda
def test_photometric_loss_card_matches_cpu(cuda_card):
    photometric_card_vs_cpu(cuda_card)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_card, tmp_path):
    """A card state saved and restored into a fresh card state: the network
    bit-equal, the optimizer's moments and step counts, the scheduler, the
    epoch and step."""
    cfg = train_config()
    task = build_task(cfg, device=cuda_card)
    batch = {k: v.to(cuda_card) for k, v in
             synthetic_batch(np.random.RandomState(1), 2, 64, 96).items()}
    state, _, _ = one_step(task, batch)
    state.scheduler.step()
    state.epoch = 1
    path = save_checkpoint(str(tmp_path / 'card.ckpt'), cfg, state, {'loss': 1.0})
    fresh = build_task(cfg, device=cuda_card)
    restored = restore_train_state(create_train_state(cfg, fresh.depth_net),
                                   load_checkpoint(path))
    assert (restored.epoch, restored.step) == (1, 1)
    for (k, a), b in zip(state.net.state_dict().items(),
                         restored.net.state_dict().values()):
        assert torch.equal(a, b), k
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, s in want['state'].items():
        for key in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(s[key].cpu(), got['state'][i][key].cpu()), (i, key)
    assert restored.scheduler.state_dict() == state.scheduler.state_dict()
    assert restored.optimizer.param_groups[0]['lr'] == state.optimizer.param_groups[0]['lr']


@pytest.mark.cuda
def test_bf16_train_step_card_matches_cpu_within_band(cuda_card):
    bf16_card_vs_cpu(cuda_card)


@pytest.mark.cuda
def test_remat_step_on_card_equals_plain_step(cuda_card):
    batch = synthetic_batch(np.random.RandomState(0), 2, 64, 96)
    remat_vs_plain(cuda_card, {r: remat_config(r) for r in (False, True, 'conv')}, batch)
