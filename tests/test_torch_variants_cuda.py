"""The depth networks and tasks added beside PackNet-SAN 1A, on the card
against the CPU, and the card's GroupNorm against fp64; the helpers
``chip_smoke.py`` phase 13 shares.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_variants_cuda.py

Without a CUDA device the card tests skip.  Both sides start from the same
seeded weights and inputs, TF32 off (``models.packnet.to_device``):

* ``eval_card_vs_cpu``: the eval forward of the 4-channel PackNet-SAN 1A
  with LiDAR, PackNet-SAN 1B, ``PackNet01`` 1A and 1B at [2,64,96],
  channels (16,)*6; all 4 scales within rtol 1e-4, atol 1e-5.
* ``train_step_card_vs_cpu`` with ``PACKNET01_SELFSUP``: one
  ``train_step`` of ``SelfSupModel`` + ``PoseNet`` on ``PackNet01``, held
  as phase 8a holds ``SemiSupModel`` (tests/test_torch_train_cuda.py), but
  with a noise floor of 1e-5 of the network's largest |gradient| where
  ``SemiSupModel``'s is 1e-6: the photometric loss alone drives this
  step, and its card-vs-CPU gap (ROADMAP L1, ~1e-4 of a tensor's largest)
  reaches the small tensors as absolute noise; ``encoder.pack5.conv3d``'s
  bias, below 1e-2 of the network's largest, differed by 1.16e-6 of it
  (measured on an NVIDIA H100 80GB HBM3 at 700 W).  1e-5 is the level
  ``compare_states`` holds a vanishing tensor to.
* ``patch_logits_card_vs_cpu``: the generic camera's gather-and-contract
  autograd function on the card against the CPU, within 1e-5;
  ``camera_generic_card_vs_fp64``: ``view_synthesis_generic`` on pinhole
  rays on the card against the CPU in fp64, the image within 1e-4 and the
  gradients within 1e-3 of their largest (the CPU test's bounds).
* ``generic_step_card_vs_cpu``: one ``train_step`` of
  ``GenericSelfSupModel`` (``RaySurfaceResNet`` 18 + ``PoseNet``) at
  progress 0.5: the loss and metrics rtol 1e-4 (phase 8a's), but for
  ``grad_norm``; each network's backward from seeded cotangents within
  8a's gradient bound; the step's own gradients against the CPU's fp64
  within ``GENERIC_STEP_BAND`` times the CPU's fp32 error
  (``generic_step_gaps`` says why no tighter).  ``generic_step_job`` runs
  it in spawned ranks, ``l4_process`` measures one fresh process under a
  cuDNN setting and every conv against fp64 (``generic_conv_fp64_gaps``;
  ``python -m tests.test_torch_variants_cuda SETTING OUT.json``).
* ``group_norm_fp64_gaps`` (ROADMAP Queue 3, L2): the seeded (16,)*6
  PackNet-SAN 1A on the blocky grey frames of
  ``tests/test_torch_spatial_cuda.blocky_frames`` at [4,128,128], its
  fp32 forward through ``F.group_norm`` and through the two-pass
  statistics of ``parallel/spatial.group_norm`` (a space of one), each
  against the fp64 forward on the CPU: the largest relative error at each
  scale.
"""

import copy

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.geometry import camera_generic
from mindtheedge_tpu_torch.models import packnet
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from tests.test_torch_spatial_cuda import blocky_frames
from tests.test_torch_train_cuda import (
    GRAD_RTOL, selfsup_batch, set_pose_head_bias, smooth_images, task_config,
    train_step_card_vs_cpu)

CHANNELS = (16,) * 6
SHAPE = (2, 64, 96)
EVAL_CASES = {   # name: (network, LiDAR)
    'PackNetSAN 1A rgb_edge': (lambda: packnet.PackNetSAN(CHANNELS, input_channels=4), True),
    'PackNetSAN 1B': (lambda: packnet.PackNetSAN(CHANNELS, version='1B'), True),
    'PackNet01 1A': (lambda: packnet.PackNet01(CHANNELS), False),
    'PackNet01 1B': (lambda: packnet.PackNet01(CHANNELS, version='1B'), False),
}


def packnet01_selfsup_config():
    """``SelfSupModel`` + ``PoseNet`` on ``PackNet01`` 1A at (16,)*6."""
    cfg = task_config('SelfSupModel', 0.0, 'PoseNet')
    cfg.model.depth_net.name = 'PackNet01'
    return cfg


PACKNET01_SELFSUP = (packnet01_selfsup_config, selfsup_batch, 1e-5)


def eval_inputs(shape=SHAPE, seed=1):
    """rgb, 95 %-empty LiDAR and an rgb_edge map in [0.2, 1], NHWC, CPU."""
    b, h, w = shape
    rng = np.random.RandomState(seed)
    rgb = rng.rand(b, h, w, 3).astype(np.float32)
    lidar = rng.rand(b, h, w, 1).astype(np.float32) * 80.0
    lidar[rng.rand(b, h, w, 1) < 0.95] = 0.0
    edge = rng.uniform(0.2, 1.0, (b, h, w, 1)).astype(np.float32)
    return [torch.from_numpy(a) for a in (rgb, lidar, edge)]


def eval_card_vs_cpu(dev, name, shape=SHAPE):
    """The eval forward of ``EVAL_CASES[name]`` on ``dev`` and on the CPU
    from the same seeded weights -> the largest |error| over the 4
    scales, each held within rtol 1e-4, atol 1e-5."""
    make, with_lidar = EVAL_CASES[name]
    net = packnet.init_weights(make(), seed=0)
    card = packnet.to_device(copy.deepcopy(net), dev)
    host = packnet.to_device(net, 'cpu')
    rgb, lidar, edge = eval_inputs(shape)
    lidar = lidar if with_lidar else None
    with torch.no_grad():
        want = host(rgb, lidar, rgb_edge=edge)['inv_depths']
        got = card(rgb.to(dev), None if lidar is None else lidar.to(dev),
                   rgb_edge=edge.to(dev))['inv_depths']
    assert len(got) == len(want) == 4
    worst = 0.0
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f'{name} scale {s}')
        worst = max(worst, float((g.cpu() - w).abs().max()))
    return worst


def pinhole_rays(b, h, w):
    """[b,h,w,3] unit rays of a pinhole camera (fx = 0.6 w, fy = 0.9 h,
    principal point off the pixel grid): neighbouring pixels' rays differ
    by ~1/f rad, so a patch's logits are far apart over the temperature."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    rays = np.stack([(xs - w / 2 + 0.3) / (0.6 * w), (ys - h / 2 + 0.2) / (0.9 * h),
                     np.ones((h, w))], -1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return np.ascontiguousarray(np.broadcast_to(rays, (b, h, w, 3)), np.float32)


def _grads_close(got, want, bound, what):
    """Each of ``got`` within ``bound`` of its ``want``'s largest |value|
    -> the worst ratio."""
    worst = 0.0
    for name, (g, w) in enumerate(zip(got, want)):
        top = float(w.abs().max())
        err = float((g.double().cpu() - w.double().cpu()).abs().max()) / top
        assert err <= bound, (what, name, err)
        worst = max(worst, err)
    return worst


def patch_logits_card_vs_cpu(dev, b=2, h=24, w=40, radius=5):
    """``camera_generic._PatchLogits`` (the gather, its re-gather and the
    int32 ``index_add_`` of its backward) on ``dev`` against the CPU, on
    seeded unit directions, rays and cotangents -> the worst error of the
    logits and of the two gradients over their largest |value|, each held
    within 1e-5 (fp32 sums of 3 or of up to 11^2 terms a patch)."""
    rng = np.random.RandomState(5)
    n, k = h * w, (2 * radius + 1) ** 2
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    arrays = [unit(rng.randn(b, n, 3)).astype(np.float32),
              unit(rng.randn(b, n, 3)).astype(np.float32),
              rng.randn(b, n, k).astype(np.float32)]
    sides = []
    for device in ('cpu', dev):
        direction, rays, cot = (torch.from_numpy(a).to(device) for a in arrays)
        direction.requires_grad_()
        rays.requires_grad_()
        start, offset = camera_generic._patch_grid(h, w, radius, device)
        logits = camera_generic._PatchLogits.apply(
            direction, rays, camera_generic._flat_index(start, offset, w))
        (logits * cot).sum().backward()
        sides.append([logits.detach(), direction.grad, rays.grad])
    return _grads_close(sides[1], sides[0], 1e-5, '_PatchLogits')


def camera_generic_card_vs_fp64(dev, shape=(2, 32, 48), radius=4):
    """``view_synthesis_generic`` on a pinhole camera's unit rays (smooth
    depths of 5-20 m and image, a pose moving points by a few pixels), its
    warped image and the gradients of a seeded weighting of it with respect
    to the depth and both ray surfaces, on ``dev`` against the CPU in fp64
    -> the worst gradient error over its tensor's largest: the image within
    1e-4, each gradient within 1e-3, the bounds the CPU test holds the
    port's fp32 to (tests/test_torch_camera_generic.py)."""
    b, h, w = shape
    rng = np.random.RandomState(0)
    depth, image = smooth_images(rng, 2, b, h, w)
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, :3, 3] = rng.uniform(-0.3, 0.3, (b, 3))
    weights = rng.randn(b, h, w, 3).astype(np.float32)
    depth = (5 + 15 * depth[..., :1]).astype(np.float32)
    rays = pinhole_rays(b, h, w)
    sides = []
    for device, dtype in ((dev, torch.float32), ('cpu', torch.float64)):
        t = lambda a: torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)
        leaves = [t(a).requires_grad_() for a in (depth, rays, rays)]
        out = camera_generic.view_synthesis_generic(t(image), *leaves, t(pose), 0.5,
                                                    'zeros', radius)
        (out * t(weights)).sum().backward()
        sides.append((out.detach(), [x.grad for x in leaves]))
    (out32, g32), (out64, g64) = sides
    _grads_close([out32], [out64], 1e-4 / float(out64.abs().max()), 'warped image')
    return _grads_close(g32, g64, 1e-3, 'view_synthesis_generic')


def generic_config():
    """``GenericSelfSupModel``: ``RaySurfaceResNet`` 18 and ``PoseNet``,
    every scale upsampled to full size (a patch must fit each scale's
    half-size image, 64 rows here)."""
    cfg = task_config('GenericSelfSupModel', 0.0, 'PoseNet')
    cfg.model.depth_net.name = 'RaySurfaceResNet'
    cfg.model.depth_net.version = ''
    cfg.model.loss.upsample_depth_maps = True
    return cfg


def _generic_step(task, batch, progress):
    """One ``train_step`` of ``task`` -> (metrics as floats, {network: its
    gradient as one fp64 vector on the CPU})."""
    state = create_train_state(task.config, task.depth_net, pose_net=task.pose_net)
    metrics = make_train_step(task)(state, batch, torch.Generator(task.device), progress)
    grads = {tag: torch.cat([p.grad.detach().reshape(-1).double().cpu()
                             for p in net.parameters()])
             for tag, net in (('depth', task.depth_net), ('pose', task.pose_net))}
    return {k: float(v) for k, v in metrics.items()}, grads


def _backward_gap(nets, inputs, seed=3):
    """The training forward of ``nets`` (the same network on the CPU and
    on the card) on ``inputs(device)``, then the backward of <outputs,
    seeded cotangents> -> the worst gradient error over its tensor's
    largest |gradient|, each held within ``GRAD_RTOL`` (a tensor below 1e-5
    of the network's largest vanishes analytically: within 1e-5 of that)."""
    grads = []
    for net in nets:
        device = next(net.parameters()).device
        net.train().zero_grad()
        out = net(*inputs(device))
        outs = [out] if torch.is_tensor(out) else \
            list(out['inv_depths']) + [out['ray_surface']]
        rng = np.random.RandomState(seed)
        sum((o * torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(device)).sum()
            for o in outs).backward()
        grads.append({n: p.grad.detach().cpu() for n, p in net.named_parameters()})
    card, host = grads
    top = max(float(g.abs().max()) for g in host.values())
    worst = 0.0
    for name, g in host.items():
        scale = float(g.abs().max())
        err = float((card[name] - g).abs().max())
        if scale < 1e-5 * top:
            assert err <= 1e-5 * top, name
            continue
        assert err <= GRAD_RTOL * scale, (name, err / scale)
        worst = max(worst, err / scale)
    return worst


GENERIC_STEP_BAND = 10      # see generic_step_gaps


def _generic_setup(shape=SHAPE):
    """:func:`generic_config`, its two networks' seeded state dicts
    (disparity heads biased to ~5 m, the pose head to a few pixels of
    motion) and a seeded ``selfsup_batch`` on the CPU."""
    cfg = generic_config()
    host = build_task(cfg, device='cpu')
    set_pose_head_bias(host.pose_net, np.random.RandomState(1))
    with torch.no_grad():
        for s in range(4):
            host.depth_net.decoder.decoder[10 + s].conv.bias.fill_(-4.0)
    weights = [copy.deepcopy(net.state_dict()) for net in (host.depth_net, host.pose_net)]
    return cfg, weights, selfsup_batch(np.random.RandomState(0), *shape)


def generic_step_card_vs_cpu(dev, shape=SHAPE, progress=0.5):
    """:func:`generic_step_gaps`, the step's gradients held against fp64
    within ``GENERIC_STEP_BAND`` times the CPU's own fp32 error."""
    gaps = generic_step_gaps(dev, shape, progress)
    for tag, g in gaps['step'].items():
        assert g['card_64'] <= GENERIC_STEP_BAND * g['cpu_64'], (tag, g)
    return gaps


def generic_step_gaps(dev, shape=SHAPE, progress=0.5):
    """``GenericSelfSupModel`` from the same weights and batch
    (:func:`_generic_setup`), on ``dev`` and on the CPU -> {'backward':
    {network: the worst gradient
    error of its backward over its tensor's largest}, 'step': {network:
    relative L2 gradient errors {'card_cpu': the card's against the CPU's,
    'cpu_64': the CPU's fp32 against its fp64, 'card_64': the card's
    against the CPU's fp64, 'card_card': a second card step's against the
    first (``_PatchLogits``' backward scatters with ``index_add_``, whose
    atomics add in no fixed order on the card)}}}.

    Held here: one ``train_step``'s loss and metrics within rtol 1e-4 (but
    ``grad_norm``), and each network's backward from seeded cotangents
    (``RaySurfaceResNet``'s 4 inverse depths and ray surface in training
    mode, ``PoseNet``'s pose vectors) within ``GRAD_RTOL`` of each
    tensor's largest, phase 8a's bound.  Not held to the CPU's: the whole
    step's gradients, which are ill-conditioned in fp32 on any device: a
    near-tie of the soft argmax multiplies a rounding by up to 1/T = 1e4,
    and ~1 % of the coordinates land within 1e-4 px of a pixel centre,
    where the bilinear sampler's derivative jumps (counted on the CPU at
    this shape), so two devices' roundings part there.  The card's step
    gradients lay 0.56 (depth, relative L2) from the CPU's while the CPU's
    fp32 lay 0.065 from its fp64, the loss within 1e-4 (measured on an
    NVIDIA H100 80GB HBM3 at 700 W); the camera's own pieces are held on the card
    by :func:`patch_logits_card_vs_cpu` and
    :func:`camera_generic_card_vs_fp64`.  :func:`generic_step_card_vs_cpu`
    holds the step's gradients only against fp64, by a band of the CPU's
    own fp32 error measured in the same call: the card's within
    ``GENERIC_STEP_BAND`` times it.  ROADMAP L4, kept on purpose: the card's
    ratio takes one value a process, set by the algorithms cuDNN picks
    there (8.64, 8.22 or 2.14 times the CPU's with the autotuner, 2.45 with
    its heuristics, 8.64 or 2.14 with ``deterministic``, over 8 fresh
    processes each), while every conv's fp32 output and gradients lie
    within 3.3e-6 of fp64 in every process (:func:`generic_conv_fp64_gaps`):
    no algorithm is less exact, the step magnifies whichever rounding it
    gets (NVIDIA H100 80GB HBM3, 700 W)."""
    cfg, weights, batch = _generic_setup(shape)
    cast = lambda v, f: [f(x) for x in v] if isinstance(v, list) else f(v)
    sides = {}
    for side, device, dtype in (('card', dev, torch.float32), ('card2', dev, torch.float32),
                                ('cpu', 'cpu', torch.float32), ('cpu64', 'cpu', torch.float64)):
        task = build_task(cfg, device=device)
        for net, sd in zip((task.depth_net, task.pose_net), weights):
            net.load_state_dict(sd)
            net.to(dtype)
        tb = {k: cast(v, lambda x: x.to(device=device, dtype=dtype)) for k, v in batch.items()}
        sides[side] = (task, tb, _generic_step(task, tb, progress))
    (card_task, card_batch, (m_card, g_card)), (cpu_task, cpu_batch, (m_cpu, g_cpu)), \
        (_, _, (_, g_64)) = (sides[k] for k in ('card', 'cpu', 'cpu64'))
    assert set(m_card) == set(m_cpu)
    for k in set(m_cpu) - {'grad_norm'}:     # a gradient's norm: not held
        np.testing.assert_allclose(m_card[k], m_cpu[k], rtol=1e-4, err_msg=k)
    for net, sd in zip((card_task.depth_net, card_task.pose_net), weights):
        net.load_state_dict(sd)     # the weights before the step, on both sides
    for net, sd in zip((cpu_task.depth_net, cpu_task.pose_net), weights):
        net.load_state_dict(sd)
    on = lambda device, key: (card_batch if device.type == 'cuda' else cpu_batch)[key]
    backward = {
        'depth': _backward_gap((card_task.depth_net, cpu_task.depth_net),
                               lambda d: (on(d, 'rgb'),)),
        'pose': _backward_gap((card_task.pose_net, cpu_task.pose_net),
                              lambda d: (on(d, 'rgb'), on(d, 'rgb_context')))}
    g_card2 = sides['card2'][2][1]
    l2 = lambda a, b, tag: float((a[tag].double() - b[tag].double()).norm() / g_64[tag].norm())
    step = {tag: {'card_cpu': l2(g_card, g_cpu, tag), 'cpu_64': l2(g_cpu, g_64, tag),
                  'card_64': l2(g_card, g_64, tag), 'card_card': l2(g_card2, g_card, tag)}
            for tag in g_cpu}
    return {'backward': backward, 'step': step}


def generic_step_job(rank, world, device):
    """:func:`generic_step_card_vs_cpu` as a job of spawned ranks
    (``tests/test_torch_dp_cuda.start_ranks``), each a fresh process whose
    cuDNN autotuner picks its own algorithms (ROADMAP L4) -> its gaps, and
    the NMS kernel's launches in this job alone."""
    from mindtheedge_tpu_torch.ops.cuda import nms_kernel
    nms_kernel.launches = 0
    out = generic_step_card_vs_cpu(torch.device(device))
    out['nms_launches'] = nms_kernel.launches
    return out


def _conv_calls(net, *inputs):
    """``net``'s forward on ``inputs`` -> (its output, {conv name: (its
    input, its output) at its first call})."""
    seen = {}

    def keep(name, args, out):
        seen.setdefault(name, (args[0].detach(), out.detach()))

    hooks = [m.register_forward_hook(lambda m, args, out, name=name: keep(name, args, out))
             for name, m in net.named_modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        out = net(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


def _card_kernels(fn, dev):
    """``fn()`` under ``torch.profiler`` -> (its result, the names of the
    card kernels it launched; none off the card)."""
    from torch.profiler import ProfilerActivity, profile
    if torch.device(dev).type != 'cuda':
        return fn(), []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})


def generic_conv_fp64_gaps(dev, shape=SHAPE):
    """Where the generic step's fp32 rounding comes from on ``dev``
    (ROADMAP L4), against fp64 on the CPU, from :func:`_generic_setup`'s
    weights and batch -> {'outputs': the largest error over the fp64
    value's largest |value| of each output of ``RaySurfaceResNet``'s
    training forward (the 4 inverse depths, the ray surface) and of
    ``PoseNet``'s pose vectors, the card's fp32 networks on the fp32 batch;
    'convs': {conv: {'forward', 'dgrad', 'wgrad': the same error of the
    conv's output, input gradient and weight gradient, the card's fp32
    conv on the input the fp64 forward gave it, rounded to fp32, with
    seeded cotangents; 'shape': its input's; 'kernels': the card kernels
    of that forward and backward, by ``torch.profiler``}}}."""
    cfg, weights, batch = _generic_setup(shape)
    task64 = build_task(cfg, device='cpu')
    task32 = build_task(cfg, device=dev)
    for task, dtype in ((task64, torch.float64), (task32, torch.float32)):
        for net, sd in zip((task.depth_net, task.pose_net), weights):
            net.load_state_dict(sd)
            net.to(dtype)
    err = lambda got, want: float((got.detach().double().cpu() - want).abs().max()
                                  / want.abs().max())
    outputs, convs = {}, {}
    for tag, inputs in (('depth', lambda t: (t['rgb'],)),
                        ('pose', lambda t: (t['rgb'], t['rgb_context']))):
        on = lambda device, dtype: {k: [x.to(device, dtype) for x in v] if isinstance(v, list)
                                    else v.to(device, dtype) for k, v in batch.items()}
        net64 = task64.depth_net.train() if tag == 'depth' else task64.pose_net.eval()
        net32 = task32.depth_net.train() if tag == 'depth' else task32.pose_net.eval()
        with torch.no_grad():
            out64, calls = _conv_calls(net64, *inputs(on('cpu', torch.float64)))
            out32 = net32(*inputs(on(dev, torch.float32)))
        if tag == 'depth':
            for i, (g, w) in enumerate(zip(out32['inv_depths'], out64['inv_depths'])):
                outputs[f'inv_depths[{i}]'] = err(g, w)
            outputs['ray_surface'] = err(out32['ray_surface'], out64['ray_surface'])
        else:
            outputs['pose'] = err(out32, out64)
        modules64, modules32 = dict(net64.named_modules()), dict(net32.named_modules())
        for i, (name, (x64, y64)) in enumerate(calls.items()):
            cot = torch.from_numpy(np.random.RandomState(i).randn(*y64.shape))
            x = x64.clone().requires_grad_()
            conv64 = modules64[name]
            gx64, gw64 = torch.autograd.grad((conv64(x) * cot).sum(), (x, conv64.weight))
            conv32 = modules32[name]
            x32 = x64.float().to(dev).requires_grad_()

            def card():
                y = conv32(x32)
                return (y,) + torch.autograd.grad((y * cot.float().to(dev)).sum(),
                                                  (x32, conv32.weight))

            (y32, gx32, gw32), kernels = _card_kernels(card, dev)
            convs[f'{tag}.{name}'] = {'forward': err(y32, y64), 'dgrad': err(gx32, gx64),
                                      'wgrad': err(gw32, gw64), 'shape': list(x64.shape),
                                      'kernels': kernels}
    return {'outputs': outputs, 'convs': convs}


# cuDNN's algorithm choice, applied after each ``models.packnet._cuda_fp32``
CUDNN_SETTINGS = {
    'benchmark': {},        # the port's: the autotuner on
    'heuristics': {'benchmark': False},
    'deterministic': {'deterministic': True},
}


def l4_process(setting, convs=True):
    """One fresh process's L4 measurement under ``CUDNN_SETTINGS[setting]``
    on the card: :func:`generic_step_gaps` and the ratio of the card's
    fp32 gap to fp64 over the CPU's for each network, then (``convs``)
    :func:`generic_conv_fp64_gaps` -> a JSON-ready dict."""
    flags = CUDNN_SETTINGS[setting]
    plain = packnet._cuda_fp32

    def cuda_fp32(device):
        plain(device)
        for k, v in flags.items():
            setattr(torch.backends.cudnn, k, v)

    packnet._cuda_fp32 = cuda_fp32
    try:
        dev = torch.device('cuda')
        gaps = generic_step_gaps(dev)
        out = {'setting': setting, 'flags': {k: getattr(torch.backends.cudnn, k) for k in
                                             ('benchmark', 'deterministic', 'allow_tf32')},
               'ratio': {tag: g['card_64'] / g['cpu_64'] for tag, g in gaps['step'].items()},
               'gaps': gaps}
        if convs:
            out.update(generic_conv_fp64_gaps(dev))
    finally:
        packnet._cuda_fp32 = plain
    return out


def group_norm_fp64_gaps(dev, shape=(4, 128, 128)):
    """The seeded (16,)*6 PackNet-SAN 1A's fp32 forward on blocky frames,
    through ``F.group_norm`` ('plain') and through the two-pass statistics
    of ``parallel/spatial.group_norm`` at a space of one ('two_pass'),
    against its fp64 forward on the CPU (the card's pack-layer kernel takes
    no fp64), on ``dev`` -> {kind: the largest relative error at each of the
    4 scales}."""
    b, h, w = shape
    rgb = torch.from_numpy(blocky_frames(np.random.RandomState(0), b, h, w)).to(dev)
    net = serve.build(CHANNELS, device=dev, seed=0)
    with torch.no_grad():
        net64 = copy.deepcopy(net).cpu().double()
        exact = [e.to(dev) for e in net64(rgb.cpu().double())['inv_depths']]
        out = {'plain': net(rgb)['inv_depths']}
        spatial.shard_network(net, spatial.Space(1))
        out['two_pass'] = net(rgb)['inv_depths']
        spatial.shard_network(net, None)
    return {kind: [float(((g.double() - e).abs() / e.abs()).max()) for g, e in zip(got, exact)]
            for kind, got in out.items()}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', list(EVAL_CASES))
def test_eval_forward_card_matches_cpu(cuda_card, name):
    eval_card_vs_cpu(cuda_card, name)


@pytest.mark.cuda
def test_packnet01_selfsup_step_card_matches_cpu(cuda_card):
    train_step_card_vs_cpu(cuda_card, spec=PACKNET01_SELFSUP)


@pytest.mark.cuda
def test_generic_camera_card_matches_cpu(cuda_card):
    patch_logits_card_vs_cpu(cuda_card)
    camera_generic_card_vs_fp64(cuda_card)


@pytest.mark.cuda
def test_generic_selfsup_step_card_matches_cpu(cuda_card):
    generic_step_card_vs_cpu(cuda_card)


@pytest.mark.cuda
def test_card_group_norm_against_fp64(cuda_card):
    """A measurement first (ROADMAP L2): the two-pass statistics stay
    within 3e-5 of fp64, as they do on the CPU."""
    gaps = group_norm_fp64_gaps(cuda_card)
    assert max(gaps['two_pass']) <= 3e-5, gaps


if __name__ == '__main__':
    # python -m tests.test_torch_variants_cuda SETTING OUT.json: one L4
    # measurement (l4_process) in this fresh process, on the card
    import json
    import sys
    result = l4_process(sys.argv[1])
    with open(sys.argv[2], 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps({'setting': result['setting'], 'ratio': result['ratio'],
                      'worst_conv': max(result['convs'].items(),
                                        key=lambda kv: max(kv[1]['forward'], kv[1]['dgrad'],
                                                           kv[1]['wgrad']))[0]}))
