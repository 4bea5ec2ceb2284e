"""The warp's geometry kernel (mindtheedge_tpu_torch/csrc/warp_kernel.cu) on
the card: its coordinates, the depth's gradient and the pose's [B,4,4]
gradient against autograd of the plain version (:func:`plain`,
``project(reconstruct(...))``, which ``view_synthesis`` runs on the CPU) at the self-supervised cell's [3,384,1280]
with per-frame K and ref_K and at a ragged [2,37,101]; the pose's
gradient through ``pose_vec2mat`` from a [B,6] vector; pixels whose P_z
falls under the clamp; ``view_synthesis`` in both padding modes; two
backward runs bit for bit; the wrapper's refusals; and the launches of one
``SelfSupTask`` step.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_kernel_cuda.py
    python -m tests.test_torch_warp_kernel_cuda OUT.json   # errors and times, PERF.md

Without a CUDA device the card tests skip.  Both sides run in float32 on
the card, TF32 off; the plain version's fp64 on the card is the oracle of
the sums.  Tolerances:

* each of the coordinates, the depth's gradient and the pose's gradient
  is held against the plain version in fp64: the kernel's largest error
  at most twice the plain fp32's, or within its tolerance.  Coordinates
  and the depth's gradient are compared per element, in units of |value|
  + the median |value|, tolerance ``ELEM_RTOL`` (1e-5): both fp32 chains
  round the same per-pixel arithmetic in another order (the kernel's fma
  chains, cuBLAS's 3x3 products with K = 3), a few ulps, which a
  cancellation in P or a clamped Z (1/Z = 1e5) magnifies alike.  The
  pose's gradient is 12 sums a frame over its H*W pixels, compared by
  the largest error of a frame over its largest |entry|, tolerance
  ``SUM_RTOL`` (1e-5): cuBLAS sums each over the frame's 491,520 terms in
  one tile, the kernel in registers, warps, blocks and a second pass.
* through the sampler (``view_synthesis``): the warped image within 1e-5;
  gradients by relative L2 within ``SAMPLER_RTOL`` (1e-4).  The bilinear
  sampler's derivative jumps at integer coordinates, where one ulp of a
  coordinate moves a pixel's gradient by the image's change of slope
  (the images here are smooth, as ``smooth_images`` makes them).
"""

import json
import sys

import pytest
import torch

from mindtheedge_tpu_torch.geometry import camera
from mindtheedge_tpu_torch.geometry.pose import pose_vec2mat
from mindtheedge_tpu_torch.ops.cuda import warp_kernel
from mindtheedge_tpu_torch.utils import profiling
from portbench.common import ROOT

CELL = (3, 384, 1280)        # B, H, W of the self-supervised cell's warps
RAGGED = (2, 37, 101)
ELEM_RTOL = 1e-5
SUM_RTOL = 1e-5
SAMPLER_RTOL = 1e-4
KITTI = (721.5377, 721.5377, 609.5593, 172.854, 1242, 375)   # fx, fy, cx, cy, W, H
# The self-supervised step of tests/test_torch_selfsup_reference.py, whose
# import would set the process's CPU threads to 1.
STEP_CHANNELS = (16,) * 6
STEP_SHAPE = (2, 64, 96)
STEP_SEED = 2 ** 31 + 7
STEP_CONFIG = ROOT / 'portbench' / 'configs' / 'packnet01_selfsup_kitti_hr.json'
STEP_TRAFFIC = ROOT / 'portbench' / 'workloads' / 'train.selfsup.b3.bf16.json'


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc')
    return torch.device('cuda')


def intrinsics(b, h, w, stretch):
    """[b,3,3] KITTI P2 intrinsics scaled to (h, w), frame i's focal lengths
    times (1 + stretch * i)."""
    fx, fy, cx, cy, w0, h0 = KITTI
    k = torch.zeros(b, 3, 3)
    for i in range(b):
        s = 1 + stretch * i
        k[i] = torch.tensor([[fx * w / w0 * s, 0.0, cx * w / w0],
                             [0.0, fy * h / h0 * s, cy * h / h0],
                             [0.0, 0.0, 1.0]])
    return k


def warp_inputs(shape, device, seed=0, behind=0.0):
    """(depth [B,H,W,1] in 2-80 m, K, ref_K (per frame, unlike K), pose
    vectors [B,6] (0.8 m and 0.6 degrees at most), the coordinates'
    upstream gradient [B,H,W,2]); a share ``behind`` of the pixels gets a
    negative depth, so that its P_z falls under the clamp."""
    b, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    depth = 2.0 + 78.0 * torch.rand(b, h, w, 1, generator=gen)
    if behind:
        depth = torch.where(torch.rand(b, h, w, 1, generator=gen) < behind, -depth, depth)
    vec = torch.cat([0.8 * (2 * torch.rand(b, 3, generator=gen) - 1),
                     0.01 * (2 * torch.rand(b, 3, generator=gen) - 1)], 1)
    grad = torch.randn(b, h, w, 2, generator=gen)
    on = lambda t: t.to(device).contiguous()
    return (on(depth), on(intrinsics(b, h, w, 0.02)), on(intrinsics(b, h, w, -0.015)),
            on(vec), on(grad))


def plain(depth, K, ref_K, pose):
    """The plain version: the coordinates of ``project(reconstruct(...))``."""
    return camera.project(camera.reconstruct(depth, K, Tcw=None, frame='w'), ref_K,
                          Tcw=pose, frame='w')


def plain_broadcast(depth, K, ref_K, pose):
    """:func:`plain` with ``transform_points``' ``points @ R^T`` as a
    broadcast multiply and sum, whose backward for R ATen reduces across the
    card: the few-line alternative to the kernel pair, timed beside it."""
    X = camera.reconstruct(depth, K, Tcw=None, frame='w')
    Y = (X[..., None, :] * pose[:, None, None, :3, :3]).sum(-1) + pose[:, None, None, :3, 3]
    return camera.project(Y, ref_K, Tcw=None, frame='w')


def coords_and_grads(fn, depth, K, ref_K, vec, grad, dtype=torch.float32, through_vec=False):
    """``fn(depth, K, ref_K, pose)`` in ``dtype`` -> (coordinates, the
    depth's gradient, the pose's [B,4,4] gradient or, ``through_vec``, the
    [B,6] vector's) of sum(coordinates * grad)."""
    cast = lambda t: t.detach().to(dtype, copy=True).contiguous()
    d = cast(depth).requires_grad_()
    v = cast(vec).requires_grad_()
    pose = pose_vec2mat(v)
    if not through_vec:
        pose = pose.detach().requires_grad_()
    coords = fn(d, cast(K), cast(ref_K), pose)
    (coords * cast(grad)).sum().backward()
    return coords.detach(), d.grad, (v if through_vec else pose).grad


def elem_err(got, want):
    """The largest |got - want| over |want| + the median |want| (a median,
    since a clamped pixel's coordinates and gradients are 1e5-1e9 times
    the others')."""
    want = want.double()
    scale = want.abs() + want.abs().median()
    return float(((got.double() - want).abs() / scale).max())


def sum_err(got, want):
    """The largest |got - want| of a frame over its largest |want|, the worst frame."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    return float(((got - want).abs().amax(1) / want.abs().amax(1)).max())


def kernel_vs_plain(shape, device, through_vec=False, behind=0.0,
                    fn=warp_kernel.WarpCoordsFn.apply):
    """The kernel (or ``fn``), the plain fp32 and the plain fp64 on the card
    -> for the coordinates, the depth's gradient and the pose's: the
    kernel's error and the plain fp32's, each against the fp64."""
    inputs = warp_inputs(shape, device, behind=behind)
    got = coords_and_grads(fn, *inputs, through_vec=through_vec)
    fp32 = coords_and_grads(plain, *inputs, through_vec=through_vec)
    exact = coords_and_grads(plain, *inputs, dtype=torch.float64, through_vec=through_vec)
    out = {'behind': int((inputs[0] < 0).sum())}
    for i, (name, err) in enumerate((('coords', elem_err), ('depth_grad', elem_err),
                                     ('pose_grad', sum_err))):
        out[name] = err(got[i], exact[i])
        out[f'plain_{name}'] = err(fp32[i], exact[i])
        out[f'{name}_vs_plain'] = err(got[i], fp32[i])
    return out


def assert_kernel_close(err):
    """The kernel within twice the plain fp32's error of the fp64, or within
    its tolerance."""
    for name, tol in (('coords', ELEM_RTOL), ('depth_grad', ELEM_RTOL), ('pose_grad', SUM_RTOL)):
        assert err[name] <= max(2 * err[f'plain_{name}'], tol), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [CELL, RAGGED], ids=['cell', 'ragged'])
def test_kernel_matches_plain_on_card(cuda_card, shape):
    assert_kernel_close(kernel_vs_plain(shape, cuda_card))


@pytest.mark.cuda
def test_pose_vector_gradient_on_card(cuda_card):
    """The [B,6] vector's gradient through ``pose_vec2mat``."""
    assert_kernel_close(kernel_vs_plain(RAGGED, cuda_card, through_vec=True))


@pytest.mark.cuda
def test_clamped_pixels_on_card(cuda_card):
    """A fifth of the pixels behind the camera: P_z under 1e-5, clamped,
    and no gradient through Z there, as ``torch.clamp``'s."""
    err = kernel_vs_plain(RAGGED, cuda_card, behind=0.2)
    assert err['behind'] > 0, err
    assert_kernel_close(err)


def smooth_image(b, h, w, device):
    """[b,h,w,3] smooth values in [0, 1]: sines of periods 20-60 pixels."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32), indexing='ij')
    chans = [0.5 + 0.25 * torch.sin(x / (7 + 2 * c) + y / (9 + c)) + 0.2 * torch.cos(y / 5.3 + c)
             for c in range(3)]
    return torch.stack(chans, -1).expand(b, h, w, 3).contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
def test_view_synthesis_padding_modes_on_card(cuda_card, padding_mode):
    """``view_synthesis`` (the kernel) against ``grid_sample`` of the plain
    coordinates, the image and the gradients of depth, pose and image."""
    depth, K, ref_K, vec, _ = warp_inputs(RAGGED, cuda_card)
    image = smooth_image(RAGGED[0], *RAGGED[1:], cuda_card)
    weights = torch.randn(image.shape, generator=torch.Generator().manual_seed(3)).to(cuda_card)
    sides = []
    for kernel in (True, False):
        d, ref = depth.clone().requires_grad_(), image.clone().requires_grad_()
        pose = pose_vec2mat(vec).requires_grad_()
        if kernel:
            out = camera.view_synthesis(ref, d, ref_K, K, pose, padding_mode)
        else:
            out = camera.grid_sample(ref, plain(d, K, ref_K, pose), padding_mode)
        (out * weights).sum().backward()
        sides.append([out.detach(), d.grad, pose.grad, ref.grad])
    got, want = sides
    assert float((got[0] - want[0]).abs().max()) <= 1e-5
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w).norm() / w.norm()) <= SAMPLER_RTOL


@pytest.mark.cuda
def test_backward_bit_equal_on_card(cuda_card):
    """Two backward runs of the same inputs give equal bits: no atomics."""
    depth, K, ref_K, vec, grad = warp_inputs(CELL, cuda_card)
    pose = pose_vec2mat(vec)
    first = warp_kernel.launch_backward(grad, depth, K, ref_K, pose)
    second = warp_kernel.launch_backward(grad, depth, K, ref_K, pose)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(first[1][:, 3], torch.zeros_like(first[1][:, 3]))


@pytest.mark.cuda
def test_wrapper_refuses_on_card(cuda_card):
    depth, K, ref_K, vec, grad = warp_inputs(RAGGED, cuda_card)
    pose = pose_vec2mat(vec)
    with pytest.raises(ValueError, match='CUDA'):
        warp_kernel.launch(depth.cpu(), K.cpu(), ref_K.cpu(), pose.cpu())
    with pytest.raises(TypeError, match='float32'):
        warp_kernel.launch(depth.double(), K.double(), ref_K.double(), pose.double())
    with pytest.raises(ValueError, match='depth'):
        warp_kernel.launch(depth[..., 0], K, ref_K, pose)
    with pytest.raises(ValueError, match='pose'):
        warp_kernel.launch(depth, K, ref_K, pose[:, :3])
    with pytest.raises(ValueError, match='contiguous'):
        warp_kernel.launch(depth.transpose(1, 2), K, ref_K, pose)
    with pytest.raises(ValueError, match='one device'):
        warp_kernel.launch(depth, K.cpu(), ref_K, pose)
    with pytest.raises(ValueError, match='gradient'):
        warp_kernel.launch_backward(grad[..., :1], depth, K, ref_K, pose)
    for i in (1, 2):
        args = [depth.requires_grad_(), K, ref_K, pose]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(ValueError, match='no gradient for K'):
            warp_kernel.WarpCoordsFn.apply(*args)


@pytest.mark.cuda
def test_selfsup_step_counts_eight_warps_on_card(cuda_card):
    """One ``SelfSupTask`` step (PackNet01 at (16,)*6, PoseNet, 2 contexts,
    4 scales, 64x96): every warp takes the kernel."""
    from mindtheedge_tpu_torch.config import get_cfg_defaults
    from mindtheedge_tpu_torch.models.packnet import to_train_device
    from mindtheedge_tpu_torch.models.tasks import build_task
    from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
    from portbench.traffic.selfsup import selfsup_pool
    b, h, w = STEP_SHAPE
    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg(json.loads(STEP_CONFIG.read_text())['train'])
    cfg.arch.precision = 'float32'
    cfg.model.depth_net.channels = STEP_CHANNELS
    task = build_task(cfg, cuda_card)
    net = to_train_device(task.depth_net, cuda_card)
    state = create_train_state(cfg, net, pose_net=task.pose_net)
    step = make_train_step(task)
    traffic = dict(json.loads(STEP_TRAFFIC.read_text()), batch=b, pool=1)
    batch = selfsup_pool(traffic, h, w, STEP_SEED, cuda_card)[0]
    profiling.reset()
    before = warp_kernel.launches
    with profiling.recording():
        step(state, batch, torch.Generator(cuda_card).manual_seed(0))
    (rec,) = profiling.records()
    assert warp_kernel.launches - before == 8
    assert rec['counters']['warp_kernel'] == 8 and rec['counters']['view_synthesis'] == 8


def event_ms(fn, iters=50):
    """The ms of one call of ``fn`` on the card: a warm call, then ``iters``
    back to back between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, iters=20):
    """{kernel name: device us a call of ``fn``}, by ``torch.profiler``
    over ``iters`` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {a.key: a.self_device_time_total / iters for a in prof.key_averages()
            if a.self_device_time_total > 0}


def times(device, shape=CELL, iters=50):
    """At ``shape``: the host-clocked ms of the kernel's forward and backward
    (the wrapper's calls, back to back), of the Function's forward +
    backward, of the plain chain's forward and forward + backward and of
    :func:`plain_broadcast`'s forward + backward; the device us of each
    kernel and of the plain chains' kernels (the cuBLAS GEMMs apart); and the
    bytes bound of each kernel pass."""
    depth, K, ref_K, vec, grad = warp_inputs(shape, device)
    pose = pose_vec2mat(vec)
    pixels = depth.numel()

    def fwd_bwd(fn):
        d, p = depth.detach().requires_grad_(), pose.detach().requires_grad_()
        torch.autograd.backward(fn(d, K, ref_K, p), grad)

    kernel = device_us(lambda: fwd_bwd(warp_kernel.WarpCoordsFn.apply))
    chain = device_us(lambda: fwd_bwd(plain))
    broadcast = device_us(lambda: fwd_bwd(plain_broadcast))
    return {'shape': list(shape),
            'kernel_fwd_ms': event_ms(lambda: warp_kernel.launch(depth, K, ref_K, pose), iters),
            'kernel_bwd_ms': event_ms(
                lambda: warp_kernel.launch_backward(grad, depth, K, ref_K, pose), iters),
            'kernel_fwd_bwd_ms': event_ms(lambda: fwd_bwd(warp_kernel.WarpCoordsFn.apply), iters),
            'plain_fwd_ms': event_ms(lambda: plain(depth, K, ref_K, pose), iters),
            'plain_fwd_bwd_ms': event_ms(lambda: fwd_bwd(plain), iters),
            'broadcast_fwd_bwd_ms': event_ms(lambda: fwd_bwd(plain_broadcast), iters),
            'kernel_device_us': {k: v for k, v in kernel.items() if 'warp' in k},
            'kernel_fwd_bwd_device_us': sum(kernel.values()),
            'plain_fwd_bwd_device_us': sum(chain.values()),
            'plain_gemm_device_us': sum(v for k, v in chain.items() if 'gemm' in k),
            'broadcast_fwd_bwd_device_us': sum(broadcast.values()),
            'broadcast_gemm_device_us': sum(v for k, v in broadcast.items() if 'gemm' in k),
            'bound_fwd_us': pixels * 12 / 3.35e12 * 1e6,
            'bound_bwd_us': pixels * 16 / 3.35e12 * 1e6}


if __name__ == '__main__':
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {'device': torch.cuda.get_device_name(0)}
    for name, kwargs in (('cell', {'shape': CELL}), ('ragged', {'shape': RAGGED}),
                         ('vector', {'shape': RAGGED, 'through_vec': True}),
                         ('clamped', {'shape': RAGGED, 'behind': 0.2}),
                         ('broadcast_cell', {'shape': CELL, 'fn': plain_broadcast})):
        out[name] = kernel_vs_plain(device=dev, **kwargs)
        print(name, json.dumps(out[name]), flush=True)
    out['times'] = times(dev)
    print('times', json.dumps(out['times']), flush=True)
    with open(sys.argv[1], 'w') as f:
        json.dump(out, f, indent=1)
