"""The warp's geometry on the CPU: ``camera.view_synthesis`` samples at
``project(reconstruct(...))`` bit for bit there, without a launch; the
wrapper's checks; and the autograd Function, with autograd of the plain
chain in the kernels' place, against autograd of the plain chain bit for
bit.  The kernels themselves run only on the card
(tests/test_torch_warp_kernel_cuda.py).
"""

import pytest
import torch

from mindtheedge_tpu_torch.geometry import camera
from mindtheedge_tpu_torch.geometry.pose import pose_vec2mat
from mindtheedge_tpu_torch.ops.cuda import warp_kernel
from mindtheedge_tpu_torch.utils import profiling

torch.set_num_threads(1)

SHAPE = (2, 64, 96)


def inputs(seed=0):
    """(depth [B,H,W,1], K, ref_K, pose vectors [B,6], the coordinates'
    upstream gradient)."""
    b, h, w = SHAPE
    gen = torch.Generator().manual_seed(seed)
    depth = 2.0 + 78.0 * torch.rand(b, h, w, 1, generator=gen)
    K = torch.tensor([[0.58 * w, 0.0, 0.5 * w - 0.3], [0.0, 1.92 * h, 0.5 * h + 0.2],
                      [0.0, 0.0, 1.0]]).repeat(b, 1, 1)
    ref_K = K * torch.tensor([[1.01], [0.99], [1.0]])
    vec = torch.cat([0.8 * (2 * torch.rand(b, 3, generator=gen) - 1),
                     0.01 * (2 * torch.rand(b, 3, generator=gen) - 1)], 1)
    return depth, K, ref_K, vec, torch.randn(b, h, w, 2, generator=gen)


def plain(depth, K, ref_K, pose):
    """The plain chain, the coordinates the kernel computes."""
    return camera.project(camera.reconstruct(depth, K, Tcw=None, frame='w'), ref_K,
                          Tcw=pose, frame='w')


def test_plain_is_project_of_reconstruct():
    """``view_synthesis`` on the CPU samples at the plain chain's
    coordinates, bit for bit; it launches nothing and counts no
    ``warp_kernel``."""
    depth, K, ref_K, vec, _ = inputs()
    pose = pose_vec2mat(vec)
    image = torch.rand(*depth.shape[:3], 3, generator=torch.Generator().manual_seed(1))
    want = camera.grid_sample(image, plain(depth, K, ref_K, pose))
    before = warp_kernel.launches
    profiling.reset()
    with profiling.recording(), profiling.span('mte.train.step'):
        got = camera.view_synthesis(image, depth, ref_K, K, pose)
    assert torch.equal(got, want)
    assert warp_kernel.launches == before
    counters = profiling.records()[0]['counters']
    assert counters['view_synthesis'] == 1 and 'warp_kernel' not in counters


def _bad(case):
    depth, K, ref_K, vec, grad = inputs()
    args = [depth, K, ref_K, pose_vec2mat(vec)]
    if case == 'cpu':
        return ValueError, 'CUDA', args
    if case == 'float64':
        return TypeError, 'float32', [t.double() for t in args]
    if case == 'depth_shape':
        return ValueError, 'depth', [depth[..., 0]] + args[1:]
    if case == 'K_shape':
        return ValueError, 'K', [depth, K[:1]] + args[2:]
    if case == 'pose_shape':
        return ValueError, 'pose', args[:3] + [args[3][:, :3]]
    if case == 'non_contiguous':
        return ValueError, 'contiguous', [depth.transpose(1, 2)] + args[1:]
    raise ValueError(case)


@pytest.mark.parametrize('case', ['cpu', 'float64', 'depth_shape', 'K_shape', 'pose_shape',
                                  'non_contiguous'])
def test_wrapper_refuses(case):
    """Each check of ``launch`` and ``launch_backward`` raises before any
    kernel is loaded."""
    error, match, args = _bad(case)
    with pytest.raises(error, match=match):
        warp_kernel.launch(*args)
    grad = torch.zeros(*args[0].shape[:3], 2, dtype=args[0].dtype)
    with pytest.raises(error, match=match):
        warp_kernel.launch_backward(grad, *args)


@pytest.mark.parametrize('which', [1, 2], ids=['K', 'ref_K'])
def test_function_refuses_intrinsics_gradient(which):
    depth, K, ref_K, vec, _ = inputs()
    args = [depth, K, ref_K, pose_vec2mat(vec)]
    args[which] = args[which].clone().requires_grad_()
    with pytest.raises(ValueError, match='no gradient for K'):
        warp_kernel.WarpCoordsFn.apply(*args)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Autograd of the plain version in the kernels' place."""
    def backward(grad, depth, K, ref_K, pose):
        with torch.enable_grad():
            d, p = depth.detach().requires_grad_(), pose.detach().requires_grad_()
            return torch.autograd.grad(plain(d, K, ref_K, p), (d, p), grad)

    monkeypatch.setattr(warp_kernel, 'launch', plain)
    monkeypatch.setattr(warp_kernel, 'launch_backward', backward)


@pytest.mark.parametrize('leaves', ['both', 'depth', 'pose'])
def test_function_gradients_bit_equal(plain_kernels, leaves):
    """The Function's gradients of depth and of the [B,6] pose vector (through
    ``pose_vec2mat``) equal autograd of the plain version's; a leaf that
    needs none gets none."""
    depth, K, ref_K, vec, grad = inputs()
    sides = []
    for fn in (warp_kernel.WarpCoordsFn.apply, plain):
        d = depth.clone().requires_grad_(leaves in ('both', 'depth'))
        v = vec.clone().requires_grad_(leaves in ('both', 'pose'))
        (fn(d, K, ref_K, pose_vec2mat(v)) * grad).sum().backward()
        sides.append((d.grad, v.grad))
    for got, want in zip(*sides):
        assert (got is None) == (want is None)
        assert got is None or torch.equal(got, want)
