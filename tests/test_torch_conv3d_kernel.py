"""The pack layers' 3-D conv on the CPU: the autograd of the card's kernel
(``ops/cuda/conv3d_kernel.Conv3dOverChannelsFn``), with the plain forward in
the kernel's place, against autograd of ``F.conv3d`` bit for bit, plain and
under ``ops/remat.py``'s checkpoint, and for a channels-last input (the
NHWC path) to fp32's rounding; and ``Conv3dOverChannels`` on the CPU,
which stays ``F.conv3d`` and counts no kernel launch.  The kernel itself
runs only on the card (tests/test_torch_conv3d_kernel_cuda.py).
"""

import pytest
import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.ops import blocks, remat
from mindtheedge_tpu_torch.ops.cuda import conv3d_kernel
from mindtheedge_tpu_torch.ops.packing import channels_last
from mindtheedge_tpu_torch.utils import profiling

torch.set_num_threads(1)

SHAPE = (2, 6, 9, 13)      # B, D, H, W: odd H and W


@pytest.fixture
def plain_forward(monkeypatch):
    """The plain version in the kernel's place; counts its calls."""
    calls = []

    def launch(x, weight, bias):
        calls.append(x.shape)
        return conv3d_kernel.plain(x, weight, bias)

    monkeypatch.setattr(conv3d_kernel, 'launch', launch)
    return calls


def leaves(d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(*SHAPE, generator=gen)
    weight = torch.randn(d, 1, 3, 3, 3, generator=gen) / 27 ** 0.5
    return [t.requires_grad_() for t in (x, weight, torch.randn(d, generator=gen))]


def grads(fn, tensors, upstream):
    (fn(*tensors) * upstream).sum().backward()
    return [t.grad for t in tensors]


def reference(x, weight, bias):
    """Autograd of ``F.conv3d`` as ``Conv3dOverChannels`` ran it before."""
    b, depth, h, w = x.shape
    return F.conv3d(x.unsqueeze(1), weight, bias, padding=1).reshape(b, -1, h, w)


def kernel_fn(x, weight, bias):
    return conv3d_kernel.Conv3dOverChannelsFn.apply(x, weight, bias)


@pytest.mark.parametrize('d', [4, 8])
@pytest.mark.parametrize('policy', [None, True, 'conv'], ids=['plain', 'remat', 'remat_conv'])
def test_function_gradients_bit_equal(plain_forward, d, policy):
    """Input, weight and bias gradients of the Function equal ``F.conv3d``'s
    bit for bit; under ``remat.checkpoint`` too, where the backward runs
    the forward a second time."""
    upstream = torch.randn(SHAPE[0], d * SHAPE[1], *SHAPE[2:],
                           generator=torch.Generator().manual_seed(1))
    wrap = (lambda fn: fn) if policy is None else (
        lambda fn: lambda *t: remat.checkpoint(fn, *t, policy=policy))
    want = grads(wrap(reference), leaves(d), upstream)
    got = grads(wrap(kernel_fn), leaves(d), upstream)
    assert len(plain_forward) == (1 if policy is None else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def plain_forward_nhwc(monkeypatch):
    """The plain version in the kernel's place, its output in the input's
    layout as the kernel writes it."""
    def launch(x, weight, bias):
        y = conv3d_kernel.plain(x, weight, bias)
        return y.contiguous(memory_format=torch.channels_last) if channels_last(x) else y

    monkeypatch.setattr(conv3d_kernel, 'launch', launch)


@pytest.mark.parametrize('d', [4, 8])
@pytest.mark.parametrize('policy', [None, True], ids=['plain', 'remat'])
def test_function_nhwc_gradients(plain_forward_nhwc, d, policy):
    """A channels-last input: the Function's backward runs the conv with its
    axes in memory order (H, W, D); the gradients equal autograd of
    ``F.conv3d`` to fp32's rounding, and the input's comes back
    channels-last."""
    upstream = torch.randn(SHAPE[0], d * SHAPE[1], *SHAPE[2:],
                           generator=torch.Generator().manual_seed(1))
    wrap = (lambda fn: fn) if policy is None else (
        lambda fn: lambda *t: remat.checkpoint(fn, *t, policy=policy))
    want = grads(wrap(reference), leaves(d), upstream)
    x, weight, bias = leaves(d)
    x = x.detach().contiguous(memory_format=torch.channels_last).requires_grad_()
    out = wrap(kernel_fn)(x, weight, bias)
    assert channels_last(out)
    (out * upstream.contiguous(memory_format=torch.channels_last)).sum().backward()
    assert channels_last(x.grad)
    for g, w in zip((x.grad, weight.grad, bias.grad), want):     # sums in another order
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * float(w.abs().max()))


def test_function_input_gradient_only(plain_forward):
    """``output_mask`` follows ``needs_input_grad``: a frozen weight and
    bias get no gradient."""
    x, weight, bias = leaves(4)
    weight.requires_grad_(False)
    bias.requires_grad_(False)
    kernel_fn(x, weight, bias).square().sum().backward()
    x2 = x.detach().clone().requires_grad_()
    reference(x2, weight, bias).square().sum().backward()
    assert weight.grad is None and bias.grad is None and torch.equal(x.grad, x2.grad)


def test_module_on_cpu_is_conv3d_and_counts_no_launch():
    conv = blocks.Conv3dOverChannels(4)
    x = leaves(4)[0].detach()
    before = conv3d_kernel.launches
    profiling.reset()
    with profiling.recording(), profiling.span('mte.serve.request'):
        y = conv(x)
    (rec,) = profiling.records()
    assert 'conv3d_kernel' not in rec['counters']
    assert [s['name'] for s in rec['spans']] == ['mte.serve.request', 'mte.net.conv3d']
    assert conv3d_kernel.launches == before
    assert torch.equal(y, reference(x, conv.weight, conv.bias))


def test_launch_refuses_a_cpu_tensor():
    x, weight, bias = (t.detach() for t in leaves(4))
    with pytest.raises(ValueError):
        conv3d_kernel.launch(x, weight, bias)
