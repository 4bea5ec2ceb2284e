"""The pack layers' 3-D conv kernel (mindtheedge_tpu_torch/csrc/conv3d_kernel.cu)
on the card: against ``F.conv3d`` with TF32 off at the ten shapes of a
batch-4 request at 384x1280 (PackNet-SAN, SLIM widths), at those of a
batch-3 training step of PackNet01 at FULL widths (each printing the
wrapper's ms), and at ragged ones;
its gradients against ``F.conv3d``'s autograd, bit for bit; the same in
the NHWC layout (a channels-last input and output, the bf16 networks' path)
at the training shapes and ragged ones, its gradients to fp32's rounding
(the backward runs the conv with its axes in memory order); the wrapper's
checks, and the module's refusal of other dtypes on the card; and the
launches of one serving request and one training step.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3d_kernel_cuda.py
    python -m tests.test_torch_conv3d_kernel_cuda OUT.json   # times, PERF.md

Without a CUDA device the card tests skip.  Tolerances: float32 rtol 1e-5,
atol 1e-6 (the kernel sums the 27 taps in another order than cuDNN).
bfloat16: each element within 1 bf16 ulp of the fp32 conv of the same bf16
operands, plus the bound of the two fp32 sums' own rounding, 2 * 28 * 2^-24
times the conv of the absolute values (an output that cancels to near 0
has a bf16 ulp below the fp32 sums' error).
"""

import json
import sys

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.ops.cuda import conv3d_kernel
from mindtheedge_tpu_torch.ops.packing import channels_last
from mindtheedge_tpu_torch.utils import profiling

# name: (D, H, W) of each conv's input in a batch-4 request at 384x1280
REQUEST_SHAPES = {
    'pack1': (128, 192, 640), 'pack2': (256, 96, 320), 'pack3': (512, 48, 160),
    'pack4': (1024, 24, 80), 'pack5': (2048, 12, 40),
    'unpack5': (512, 12, 40), 'unpack4': (256, 24, 80), 'unpack3': (128, 48, 160),
    'unpack2': (64, 96, 320), 'unpack1': (32, 192, 640)}
REQUEST_B, FEATURES = 4, 4
# the same ten convs in a batch-3 training step of PackNet01 at FULL widths
# (64, 64, 64, 128, 256, 512): pack1 and unpack1 are twice as deep
FULL_SHAPES = dict(REQUEST_SHAPES, pack1=(256, 192, 640), unpack1=(64, 192, 640))
FULL_B = 3
# (B, D, H, W, d): depths below a chunk, odd H and W, W % 4 != 0, B = 1, d = 8
RAGGED = [(1, 1, 1, 1, 4), (2, 2, 5, 7, 4), (1, 3, 9, 13, 8), (3, 1, 17, 30, 4),
          (1, 2, 33, 130, 8), (2, 3, 11, 255, 4), (1, 7, 65, 643, 8), (2, 5, 6, 8, 8),
          (1, 40, 3, 41, 4)]
SUM_ULPS = 2 * 28 * 2.0 ** -24      # two fp32 sums of 27 taps and the bias


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc')
    return torch.device('cuda')


@pytest.fixture
def no_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


def operands(b, depth, h, w, d, dtype, device, seed=0):
    """Input from N(0, 1), weight and bias as ``nn.Conv3d`` draws them."""
    gen = torch.Generator().manual_seed(seed)
    conv = torch.nn.Conv3d(1, d, 3, padding=1)
    with torch.no_grad():
        for p in conv.parameters():
            p.uniform_(-1.0, 1.0, generator=gen).mul_(27 ** -0.5)
    x = torch.randn(b, depth, h, w, generator=gen)
    return [t.to(device, dtype).contiguous() for t in (x, conv.weight.detach(), conv.bias.detach())]


def bf16_ulp(v):
    """The spacing of bf16 at |v| (at least that of the smallest normal)."""
    e = torch.floor(torch.log2(v.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)))
    return torch.exp2(e - 7)


def check_against_conv3d(x, weight, bias):
    """The kernel once against ``F.conv3d`` -> the largest error over its
    tolerance (at most 1 passes).  The output keeps ``x``'s layout."""
    before = conv3d_kernel.launches
    got = conv3d_kernel.launch(x, weight, bias)
    torch.cuda.synchronize()
    assert conv3d_kernel.launches == before + 1
    b, depth, h, w = x.shape
    assert got.shape == (b, weight.shape[0] * depth, h, w) and got.dtype == x.dtype
    assert channels_last(got) == channels_last(x)
    x = x.contiguous()
    if x.dtype == torch.float32:
        want = conv3d_kernel.plain(x, weight, bias)
        err = (got - want).abs() / (1e-6 + 1e-5 * want.abs())
    else:
        x32, w32, b32 = x.float(), weight.float(), bias.float()
        want = conv3d_kernel.plain(x32, w32, b32)
        sums = conv3d_kernel.plain(x32.abs(), w32.abs(), b32.abs())
        err = (got.float() - want).abs() / (bf16_ulp(want) + SUM_ULPS * sums)
    return float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('name', list(REQUEST_SHAPES))
def test_kernel_request_shapes_on_card(cuda_card, no_tf32, name, dtype):
    x, weight, bias = operands(REQUEST_B, *REQUEST_SHAPES[name], FEATURES, dtype, cuda_card)
    assert check_against_conv3d(x, weight, bias) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('name', list(FULL_SHAPES))
def test_kernel_packnet01_full_shapes_on_card(cuda_card, no_tf32, name, dtype):
    x, weight, bias = operands(FULL_B, *FULL_SHAPES[name], FEATURES, dtype, cuda_card)
    assert check_against_conv3d(x, weight, bias) <= 1.0
    ms = event_ms(lambda: conv3d_kernel.launch(x, weight, bias), 20)
    print(f'PackNet01 FULL {name} {[FULL_B, *FULL_SHAPES[name]]} {dtype}: {ms:.4f} ms')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('shape', RAGGED, ids=['x'.join(map(str, s)) for s in RAGGED])
def test_kernel_ragged_shapes_on_card(cuda_card, no_tf32, shape, dtype):
    *dims, d = shape
    x, weight, bias = operands(*dims, d, dtype, cuda_card, seed=1)
    assert check_against_conv3d(x, weight, bias) <= 1.0
    # 4 bytes past an aligned start: element-wise accesses
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_card)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert check_against_conv3d(shifted, weight, bias) <= 1.0


def nhwc(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('name', list(FULL_SHAPES))
def test_kernel_nhwc_packnet01_full_shapes_on_card(cuda_card, no_tf32, name, dtype):
    x, weight, bias = operands(FULL_B, *FULL_SHAPES[name], FEATURES, dtype, cuda_card)
    x = nhwc(x)
    assert check_against_conv3d(x, weight, bias) <= 1.0
    ms = event_ms(lambda: conv3d_kernel.launch(x, weight, bias), 20)
    print(f'NHWC PackNet01 FULL {name} {[FULL_B, *FULL_SHAPES[name]]} {dtype}: {ms:.4f} ms')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('shape', RAGGED, ids=['x'.join(map(str, s)) for s in RAGGED])
def test_kernel_nhwc_ragged_shapes_on_card(cuda_card, no_tf32, shape, dtype):
    *dims, d = shape
    x, weight, bias = operands(*dims, d, dtype, cuda_card, seed=1)
    assert check_against_conv3d(nhwc(x), weight, bias) <= 1.0
    # 4 bytes past an aligned start: element-wise accesses
    b, depth, h, w = x.shape
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_card)
    shifted = flat[1:].view(b, h, w, depth).permute(0, 3, 1, 2)
    shifted.copy_(x)
    if depth > 1 and h * w > 1:
        assert channels_last(shifted)
    assert check_against_conv3d(shifted, weight, bias) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
def test_nhwc_gradients_on_card(cuda_card, no_tf32, dtype):
    """The Function on a channels-last input: the gradients of ``F.conv3d``'s
    autograd on the NCHW input, to the rounding of sums taken in another
    order (fp32 rtol 1e-4 of the largest; bf16 a ulp of the largest), the
    input's gradient channels-last."""
    x, weight, bias = operands(2, 16, 24, 40, FEATURES, dtype, cuda_card, seed=2)
    grad = torch.randn(2, FEATURES * 16, 24, 40, generator=torch.Generator().manual_seed(3))
    grad = grad.to(cuda_card, dtype)
    grads = []
    for fn, layout in ((conv3d_kernel.Conv3dOverChannelsFn.apply, nhwc),
                       (conv3d_kernel.plain, lambda t: t)):
        leaves = [layout(x).requires_grad_()] + [t.clone().requires_grad_()
                                                 for t in (weight, bias)]
        (fn(*leaves) * layout(grad)).sum().backward()
        grads.append([t.grad for t in leaves])
    assert channels_last(grads[0][0])
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=rtol * float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
def test_gradients_bit_equal_on_card(cuda_card, dtype):
    """The Function's input, weight and bias gradients equal autograd of
    ``F.conv3d``'s bit for bit: the same ``convolution_backward`` call,
    with cuDNN held to its deterministic algorithms."""
    x, weight, bias = operands(2, 16, 24, 40, FEATURES, dtype, cuda_card, seed=2)
    grad = torch.randn(2, FEATURES * 16, 24, 40, generator=torch.Generator().manual_seed(3))
    grad = grad.to(cuda_card, dtype)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        grads = []
        for fn in (conv3d_kernel.Conv3dOverChannelsFn.apply, conv3d_kernel.plain):
            leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
            (fn(*leaves) * grad).sum().backward()
            grads.append([t.grad for t in leaves])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_wrapper_refuses_on_card(cuda_card):
    x, weight, bias = operands(1, 4, 8, 8, FEATURES, torch.float32, cuda_card)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            conv3d_kernel.launch(x.to(dtype), weight.to(dtype), bias.to(dtype))
    with pytest.raises(ValueError):
        conv3d_kernel.launch(x.transpose(2, 3), weight, bias)
    with pytest.raises(ValueError):
        conv3d_kernel.launch(x.cpu(), weight.cpu(), bias.cpu())
    with pytest.raises(ValueError):
        conv3d_kernel.launch(x, weight.repeat(2, 1, 1, 1, 1)[:3].contiguous(), bias[:3])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float16, torch.float64], ids=['fp16', 'fp64'])
def test_module_refuses_other_dtypes_on_card(cuda_card, dtype):
    """``Conv3dOverChannels`` on the card takes the kernel for every dtype:
    fp16 and fp64 raise there, and no ``F.conv3d`` runs in the kernel's place."""
    from mindtheedge_tpu_torch.ops.blocks import Conv3dOverChannels

    conv = Conv3dOverChannels(FEATURES).to(cuda_card, dtype)
    x = torch.randn(1, 4, 8, 8, device=cuda_card, dtype=dtype)
    before = conv3d_kernel.launches
    with pytest.raises(TypeError):
        conv(x)
    assert conv3d_kernel.launches == before


def launches_and_counts(fn):
    """``fn()`` inside ``profiling.recording()`` -> (the kernel's launches,
    the ``conv3d_kernel`` counter of its one request)."""
    profiling.reset()
    before = conv3d_kernel.launches
    with profiling.recording():
        fn()
    (rec,) = profiling.records()
    return conv3d_kernel.launches - before, rec['counters'].get('conv3d_kernel')


@pytest.mark.cuda
def test_serving_request_launches_ten_on_card(cuda_card):
    model = serve.build((16,) * 6, device=cuda_card, seed=0, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    rgb_u8 = torch.randint(0, 256, (2, 64, 96, 3), generator=gen, dtype=torch.uint8)
    lidar = torch.rand(2, 64, 96, 1, generator=gen) * 80.0
    assert launches_and_counts(lambda: serve.serve(model, rgb_u8, lidar)) == (10, 10)


@pytest.mark.cuda
def test_training_step_launches_twenty_on_card(cuda_card):
    from mindtheedge_tpu_torch.models.tasks import build_task
    from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
    from tests.test_torch_train_cuda import synthetic_batch, train_config

    cfg = train_config(dropout=0.5, flip_lr_prob=0.5)
    cfg.arch.precision = 'bfloat16'
    task = build_task(cfg, device=cuda_card)
    state = create_train_state(cfg, task.depth_net)
    step = make_train_step(task)
    batch = {k: v.to(cuda_card)
             for k, v in synthetic_batch(np.random.RandomState(0), 2, 64, 96).items()}
    gen = torch.Generator(cuda_card).manual_seed(0)
    assert launches_and_counts(lambda: step(state, batch, gen)) == (20, 20)


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


def request_times(device, iters=50):
    """Each request shape's ms on the card, float32 and bfloat16: the
    kernel (its C entry point, launched back to back), the wrapper
    (:func:`conv3d_kernel.launch`, whose checks and allocation the host
    adds), ``F.conv3d`` (the plain version and the library call), and the
    bound (the larger of its bytes at 3.35 TB/s and its FMAs at 67 TFLOP/s)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, (depth, h, w) in REQUEST_SHAPES.items():
            x, weight, bias = operands(REQUEST_B, depth, h, w, FEATURES, dtype, device)
            n_in = x.numel()
            n_out = n_in * FEATURES
            bound_ms = max((n_in + n_out) * x.element_size() / 3.35e12,
                           n_out * 27 * 2 / 67e12) * 1e3
            out = conv3d_kernel.launch(x, weight, bias)
            fn, _ = conv3d_kernel._kernel()
            stream = torch.cuda.current_stream().cuda_stream
            args = (x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    conv3d_kernel.DTYPES[dtype], FEATURES, REQUEST_B, depth, h, w, stream)
            rows.append({'dtype': str(dtype).split('.')[-1], 'name': name,
                         'shape': [REQUEST_B, depth, h, w],
                         'kernel_ms': event_ms(lambda: fn(*args), iters),
                         'wrapper_ms': event_ms(lambda: conv3d_kernel.launch(x, weight, bias),
                                                iters),
                         'conv3d_ms': event_ms(lambda: conv3d_kernel.plain(x, weight, bias),
                                               iters),
                         'bound_ms': bound_ms})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == '__main__':
    dev = torch.device('cuda')
    out = {'device': torch.cuda.get_device_name(0), 'rows': request_times(dev)}
    for dtype in ('float32', 'bfloat16'):
        rows = [r for r in out['rows'] if r['dtype'] == dtype]
        out[dtype] = {k: sum(r[k] for r in rows)
                      for k in ('kernel_ms', 'wrapper_ms', 'conv3d_ms', 'bound_ms')}
        print(dtype, json.dumps(out[dtype]))
    with open(sys.argv[1], 'w') as f:
        json.dump(out, f, indent=1)
