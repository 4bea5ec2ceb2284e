"""The GroupNorm + ELU kernel pair (mindtheedge_tpu_torch/csrc/gn_elu_kernel.cu)
and the NHWC path of the bf16 depth networks on the card: the pair against
fp64 and against the plain version ``F.elu(F.group_norm(x))`` at every
GroupNorm shape of PackNet01 at FULL and SLIM widths at [3,384,1280] and at
an odd [2,37,101]; two runs bit for bit; the wrapper's refusals; the
launches of a pass (47 for PackNet01 and PackNet-SAN 1A, 94 a bf16 SAN
training step, 0 in fp32); and, in a profiled bf16 PackNet01 training step
and a PackNet-SAN bf16 request at a small shape, the layout copies left:
cuDNN's ``nchwToNhwc``/``nhwcToNchw`` and ATen's copies, which may only
copy the weights, the pack layers' shuffles, or lie in the 3-D convs'
backward.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gn_elu_kernel_cuda.py
    python -m tests.test_torch_gn_elu_kernel_cuda OUT.json   # times, PERF.md

Without a CUDA device the card tests skip.  Tolerances: the forward's y
within half a bf16 ulp of the fp64 value plus 1e-5 (1 + |z|) for the fp32
statistics; the backward's within a bf16 ulp plus 1e-4 of the largest |value|
of the fp64 evaluation of the same formulas (ELU's derivative from the bf16
output, as autograd of ``F.elu`` takes it).
"""

import collections
import json
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.models import packnet
from mindtheedge_tpu_torch.ops import blocks
from mindtheedge_tpu_torch.ops.cuda import gn_elu_kernel
from mindtheedge_tpu_torch.utils import profiling

FULL, SLIM = packnet.FULL_CHANNELS, packnet.SLIM_CHANNELS


def group_norm_shapes(channels, h, w):
    """(C, H, W) of each of the 47 GroupNorms of a PackNet01 (or PackNet-SAN)
    pass at h x w, in the order the forward runs them."""
    ni, n1, n2, n3, n4, n5 = channels
    enc = ([(ni, 0), (n1, 0), (n1, 1)] + [(n2, 1)] * 6 + [(n2, 2)] + [(n3, 2)] * 6
           + [(n3, 3)] + [(n4, 3)] * 9 + [(n4, 4)] + [(n5, 4)] * 9 + [(n5, 5)])
    dec = [(n5, 5), (n5, 4), (n4, 4), (n4, 3), (n3, 3), (n3, 2), (n2, 2), (n2, 1),
           (n1, 1), (n1, 0)]
    return [(c, h >> k, w >> k) for c, k in enc + dec]


NETWORK_SHAPES = sorted({(3, *s) for ch in (FULL, SLIM) for s in group_norm_shapes(ch, 384, 1280)},
                        key=lambda s: (-s[2], s[1]))
ODD_SHAPES = [(2, c, 37, 101) for c in (16, 32, 64, 128, 256, 512)]


def test_group_norm_shapes_are_the_networks():
    """The list above against the GroupNorms a PackNet01 forward runs (on
    the meta device, at FULL widths and 384x1280)."""
    seen = []
    net = packnet.PackNet01(FULL).to('meta').eval()
    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(tuple(a[0].shape[1:])))
             for m in net.modules() if isinstance(m, blocks.GroupNorm)]
    net(torch.empty(1, 384, 1280, 3, device='meta'))
    for h in hooks:
        h.remove()
    assert seen == group_norm_shapes(FULL, 384, 1280) and len(seen) == 47


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc')
    return torch.device('cuda')


def operands(b, c, h, w, device, seed=0):
    """bf16 channels-last x (N(0.5, 2)), weight, bias and an upstream gradient."""
    gen = torch.Generator(device).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen, device=device) * 2 + 0.5
    dy = torch.randn(b, h, w, c, generator=gen, device=device)
    weight = 1 + 0.5 * torch.randn(c, generator=gen, device=device)
    bias = 0.3 * torch.randn(c, generator=gen, device=device)
    nhwc = lambda t: t.to(torch.bfloat16).permute(0, 3, 1, 2)
    return nhwc(x), weight.to(torch.bfloat16), bias.to(torch.bfloat16), nhwc(dy)


def bf16_ulp(v):
    """The spacing of bf16 at |v| (at least that of the smallest normal)."""
    e = torch.floor(torch.log2(v.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)))
    return torch.exp2(e - 7)


def reference64(x, weight, bias, y, dy, eps=1e-5):
    """fp64: z and y = elu(z) of the bf16 operands, and the backward's
    formulas with ELU's derivative from the kernel's bf16 ``y``."""
    x64, w64, b64 = x.double(), weight.double(), bias.double()
    z = F.group_norm(x64, 16, w64, b64, eps)
    xg = x64.reshape(x.shape[0], 16, -1)
    mean, var = xg.mean(-1), xg.var(-1, unbiased=False)
    dx, dw, db = gn_elu_kernel.plain_backward(dy.double(), x64, y.double(), mean,
                                              torch.rsqrt(var + eps), w64)
    return z, F.elu(z), dx, dw, db


def check_against_fp64(x, weight, bias, dy):
    """The kernel pair once -> {name: the largest error over its tolerance}
    for y, dx, dweight, dbias (at most 1 passes); the plain version's
    forward error in the same units ('plain_y'); and the relative L2 gap of
    each of the four to the plain version's ('gap_*')."""
    before = gn_elu_kernel.launches
    leaves = [t.detach().clone().requires_grad_() for t in (x, weight, bias)]
    y = gn_elu_kernel.GroupNormEluFn.apply(*leaves, 1e-5)
    y.backward(dy)
    torch.cuda.synchronize()
    assert gn_elu_kernel.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    z, y64, dx64, dw64, db64 = reference64(x, weight, bias, y, dy)
    tol = 0.5 * bf16_ulp(y64) + 1e-5 * (1 + z.abs())
    plain_y, plain_grads = plain_pair(x, weight, bias, dy)
    y = y.detach()
    out = {'y': float(((y.double() - y64).abs() / tol).max()),
           'plain_y': float(((plain_y.double() - y64).abs() / tol).max())}
    for name, got, want, plain in (('y', y, y64, plain_y),
                                   ('dx', leaves[0].grad, dx64, plain_grads[0]),
                                   ('dweight', leaves[1].grad, dw64, plain_grads[1]),
                                   ('dbias', leaves[2].grad, db64, plain_grads[2])):
        assert got.dtype == torch.bfloat16
        if name != 'y':
            err = (got.double() - want).abs() / (bf16_ulp(want) + 1e-4 * want.abs().max())
            out[name] = float(err.max())
        out['gap_' + name] = float((got.double() - plain.double()).norm() / plain.double().norm())
    return out


def plain_pair(x, weight, bias, dy):
    """The plain version's output and gradients (autograd, bf16)."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, weight, bias)]
    y = gn_elu_kernel.plain(*leaves)
    y.backward(dy)
    return y.detach(), [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', NETWORK_SHAPES + ODD_SHAPES,
                         ids=['x'.join(map(str, s)) for s in NETWORK_SHAPES + ODD_SHAPES])
def test_kernel_pair_against_fp64_and_plain(cuda_card, shape):
    x, weight, bias, dy = operands(*shape[:2], *shape[2:], cuda_card)
    errs = check_against_fp64(x, weight, bias, dy)
    print(shape, json.dumps(errs))
    assert max(errs[k] for k in ('y', 'dx', 'dweight', 'dbias')) <= 1.0
    # ATen's bf16 GroupNorm keeps its mean and rstd in bf16 and rounds its
    # output before the ELU: the plain version lies farther from fp64, and
    # the two part by bf16's rounding
    assert errs['y'] <= errs['plain_y']
    assert max(errs[k] for k in ('gap_y', 'gap_dx', 'gap_dweight', 'gap_dbias')) < 0.05


@pytest.mark.cuda
def test_kernel_pair_repeats_bit_for_bit(cuda_card):
    x, weight, bias, dy = operands(3, 64, 96, 320, cuda_card, seed=3)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (x, weight, bias)]
        y = gn_elu_kernel.GroupNormEluFn.apply(*leaves, 1e-5)
        y.backward(dy)
        runs.append([y] + [t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_on_card(cuda_card):
    x, weight, bias, _ = operands(1, 32, 4, 6, cuda_card)
    with pytest.raises(TypeError):
        gn_elu_kernel.launch(x.float(), weight.float(), bias.float())
    with pytest.raises(ValueError):
        gn_elu_kernel.launch(x[:, :24], weight[:24], bias[:24])       # C/16 not whole
    with pytest.raises(ValueError):
        gn_elu_kernel.launch(x.cpu(), weight.cpu(), bias.cpu())
    with pytest.raises(ValueError):
        gn_elu_kernel.launch(x, weight[:16], bias[:16])


@pytest.mark.cuda
def test_sharded_block_rounds_once_as_the_kernel(cuda_card):
    """Under a ``space`` on the card ``GroupNorm.elu`` keeps NCHW and the
    kernel pair's arithmetic, ELU of ``spatial.group_norm``'s fp32 output
    rounded once: within the kernel's forward tolerance of fp64."""
    from mindtheedge_tpu_torch.parallel import spatial

    x, weight, bias, _ = operands(2, 64, 37, 101, cuda_card)
    x = x.contiguous()
    norm = blocks.GroupNorm(64).to(cuda_card, torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    norm.space = spatial.Space(1)
    before = gn_elu_kernel.launches
    y = norm.elu(x)
    assert gn_elu_kernel.launches == before
    assert y.dtype == torch.bfloat16 and y.is_contiguous()
    z = F.group_norm(x.double(), 16, weight.double(), bias.double(), 1e-5)
    tol = 0.5 * bf16_ulp(F.elu(z)) + 1e-5 * (1 + z.abs())
    assert float(((y.double() - F.elu(z)).abs() / tol).max()) <= 1.0


def launches_and_counts(fn):
    """``fn()`` inside ``profiling.recording()`` -> (the kernel's launches,
    the ``gn_elu_kernel`` counter of its one unit)."""
    profiling.reset()
    before = gn_elu_kernel.launches
    with profiling.recording():
        fn()
    (rec,) = profiling.records()
    return gn_elu_kernel.launches - before, rec['counters'].get('gn_elu_kernel', 0)


def request_inputs(b=2, h=64, w=96):
    gen = torch.Generator().manual_seed(0)
    rgb_u8 = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
    return rgb_u8, torch.rand(b, h, w, 1, generator=gen) * 80.0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,expected', [(torch.bfloat16, 47), (torch.float32, 0)],
                         ids=['bf16', 'fp32'])
def test_serving_request_launches(cuda_card, dtype, expected):
    model = serve.build((16,) * 6, device=cuda_card, seed=0, dtype=dtype)
    rgb_u8, lidar = request_inputs()
    assert launches_and_counts(lambda: serve.serve(model, rgb_u8, lidar)) == (expected,
                                                                             expected)


@pytest.mark.cuda
def test_packnet01_bf16_pass_launches_47(cuda_card):
    net = packnet.to_device(packnet.init_weights(packnet.PackNet01((16,) * 6)), cuda_card,
                            torch.bfloat16)
    rgb = torch.rand(1, 64, 96, 3, device=cuda_card, dtype=torch.bfloat16)
    with torch.no_grad():
        assert launches_and_counts(lambda: net(rgb)) == (47, 47)


def san_train_step(dev):
    """A bf16 PackNet-SAN training step (both passes) -> (step, state, batch)."""
    from mindtheedge_tpu_torch.models.tasks import build_task
    from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
    from tests.test_torch_train_cuda import synthetic_batch, train_config

    cfg = train_config(dropout=0.5, flip_lr_prob=0.5)
    cfg.arch.precision = 'bfloat16'
    task = build_task(cfg, device=dev)
    batch = {k: v.to(dev) for k, v in synthetic_batch(np.random.RandomState(0), 2, 64, 96).items()}
    return make_train_step(task), create_train_state(cfg, task.depth_net), batch


@pytest.mark.cuda
def test_bf16_training_step_launches_94(cuda_card):
    step, state, batch = san_train_step(cuda_card)
    gen = torch.Generator(cuda_card).manual_seed(0)
    assert launches_and_counts(lambda: step(state, batch, gen)) == (94, 94)


def packnet01_selfsup_step(dev):
    """A bf16 ``SelfSupModel`` + ``PoseNet`` step on PackNet01 at (16,)*6 ->
    (task, step, state, batch)."""
    from mindtheedge_tpu_torch.models.tasks import build_task
    from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
    from tests.test_torch_train_cuda import selfsup_batch
    from tests.test_torch_variants_cuda import packnet01_selfsup_config

    cfg = packnet01_selfsup_config()
    cfg.arch.precision = 'bfloat16'
    task = build_task(cfg, device=dev)
    to_dev = lambda v: [t.to(dev) for t in v] if isinstance(v, list) else v.to(dev)
    batch = {k: to_dev(v) for k, v in selfsup_batch(np.random.RandomState(0), 2, 64, 96).items()}
    state = create_train_state(cfg, task.depth_net, pose_net=task.pose_net)
    return task, make_train_step(task), state, batch


TRANSPOSES = ('nchwToNhwc', 'nhwcToNchw')


def layout_copies(fn, weight_shapes):
    """``fn()`` twice, the second under ``torch.profiler`` -> Counter of the
    device's layout copies by cause: cuDNN's transposes and the kernels of
    ATen's ``copy_`` outside dtype casts.  Causes: 'conv3d_backward' (inside
    ``convolution_backward`` of a 5-D tensor), 'weights' (a tensor of a conv
    weight's shape), 'shuffle' (inside ``reshape``: the pack layers'
    shuffles), 'one_channel' (a [B,1,H,W] map: the decoder's upsampled
    inverse depths, whose gradients arrive as slices of the join's, as in
    NCHW), 'other'."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    counts, examples = collections.Counter(), collections.defaultdict(list)
    for ev in prof.events():
        names = [k.name for k in getattr(ev, 'kernels', [])]
        moved = [n for n in names if any(t in n for t in TRANSPOSES)]
        if ev.name == 'aten::copy_':
            moved += names
        if not moved:
            continue
        chain, shapes, up = [], [tuple(s) for s in ev.input_shapes if s], ev
        while up is not None:
            chain.append(up.name)
            shapes += [tuple(s) for s in up.input_shapes if s]
            up = up.cpu_parent
        if 'aten::_to_copy' in chain and not any(s in weight_shapes for s in shapes):
            continue                                   # a dtype cast of an activation
        if any(n == 'aten::convolution_backward' for n in chain) and any(
                len(s) == 5 for s in shapes):
            cause = 'conv3d_backward'
        elif any(s in weight_shapes for s in shapes):
            cause = 'weights'
        elif 'aten::reshape' in chain:
            cause = 'shuffle'
        elif shapes and len(shapes[0]) == 4 and shapes[0][1] == 1:
            cause = 'one_channel'
        else:
            cause = 'other'
        for n in moved:
            counts[cause, 'cudnn' if any(t in n for t in TRANSPOSES) else 'aten'] += 1
            examples[cause].append((n[:60], chain[:4], shapes[:3]))
    return counts, examples


def weight_shapes(*modules):
    shapes = set()
    for m in modules:
        for p in m.parameters():
            if p.dim() >= 3:
                s = tuple(p.shape)
                shapes.add(s)
                if p.dim() == 3:          # the SAN's [K^2,I,O] as the conv's [O,I,k,k]
                    k = int(round(s[0] ** 0.5))
                    shapes.add((s[2], s[1], k, k))
                if p.dim() == 5:          # the 3-D conv as its backward takes it
                    shapes.add((s[0], s[1], s[3], s[4], s[2]))
    shapes |= {(sum(s[0] for s in group), *group[0][1:]) for group in _san_first(modules)}
    return shapes


def _san_first(modules):
    """The SAN levels' first-stage weights, concatenated on their outputs."""
    from mindtheedge_tpu_torch.ops.sparse import MinkConvBlock

    for m in modules:
        for level in m.modules():
            if isinstance(level, MinkConvBlock):
                c, k = level.out_channels, level.kernel_size
                i = level.layer1[0].kernel.shape[1]
                yield [(c, i, k, k), (2 * c, i, k, k), (2 * c, i, k, k)]


def assert_only_listed(counts, examples):
    print(json.dumps({f'{c}/{s}': n for (c, s), n in sorted(counts.items())}))
    for line in examples.get('other', [])[:20]:
        print('other:', line)
    assert not any(cause == 'other' for cause, _ in counts), dict(counts)


@pytest.mark.cuda
def test_bf16_step_layout_copies(cuda_card):
    """The depth network's part of a bf16 PackNet01 self-supervised step
    (its training forward as the step runs it, on bf16 channels-last casts
    of its weights, and its backward): the copies left are the weights',
    the shuffles' and the 3-D convs' backward."""
    task, _, _, batch = packnet01_selfsup_step(cuda_card)
    gen = torch.Generator(cuda_card).manual_seed(0)

    def depth_pass():
        task.depth_net.train()
        out = task._depth_forward(batch['rgb'], None, None, gen)
        sum(d.float().mean() for d in out['inv_depths']).backward()

    counts, examples = layout_copies(depth_pass, weight_shapes(task.depth_net))
    assert_only_listed(counts, examples)


@pytest.mark.cuda
def test_bf16_request_layout_copies(cuda_card):
    """A PackNet-SAN bf16 request: no cuDNN transpose and no ATen layout
    copy but the weights' and the shuffles'."""
    model = serve.build((16,) * 6, device=cuda_card, seed=0, dtype=torch.bfloat16)
    rgb_u8, lidar = request_inputs()
    counts, examples = layout_copies(lambda: serve.serve(model, rgb_u8, lidar),
                                     weight_shapes(model))
    assert_only_listed(counts, examples)
    assert not any(cause == 'conv3d_backward' for cause, _ in counts)


def group_norm_times(device, iters=20):
    """The kernel pair's forward and forward + backward ms at each
    GroupNorm shape of PackNet01 FULL at [3,384,1280] (events), against the
    plain version on the same channels-last input (ATen, which copies it to
    NCHW), and the bound in bytes (6 and 14 bytes an element at 3.35 TB/s)."""
    from tests.test_torch_conv3d_kernel_cuda import event_ms

    rows = []
    for shape in sorted(set((3, *s) for s in group_norm_shapes(FULL, 384, 1280)),
                        key=lambda s: -s[2]):
        x, weight, bias, dy = operands(*shape[:2], *shape[2:], device)
        xr = x.detach().clone().requires_grad_()

        def kernel_both():
            gn_elu_kernel.GroupNormEluFn.apply(xr, weight, bias, 1e-5).backward(dy)

        def plain_both():
            gn_elu_kernel.plain(xr, weight, bias).backward(dy)

        n = x.numel()
        rows.append({'shape': list(shape),
                     'kernel_device_fwd_ms': device_ms(lambda: gn_elu_kernel.launch(x, weight,
                                                                                   bias)),
                     'plain_device_fwd_ms': device_ms(lambda: gn_elu_kernel.plain(x, weight, bias)),
                     'kernel_device_fwd_bwd_ms': device_ms(kernel_both),
                     'plain_device_fwd_bwd_ms': device_ms(plain_both),
                     'kernel_fwd_ms': event_ms(lambda: gn_elu_kernel.launch(x, weight, bias),
                                               iters),
                     'plain_fwd_ms': event_ms(lambda: gn_elu_kernel.plain(x, weight, bias),
                                              iters),
                     'kernel_fwd_bwd_ms': event_ms(kernel_both, iters),
                     'plain_fwd_bwd_ms': event_ms(plain_both, iters),
                     'bound_fwd_ms': 6 * n / 3.35e12 * 1e3,
                     'bound_fwd_bwd_ms': 20 * n / 3.35e12 * 1e3})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def device_ms(fn):
    """The device time of the kernels one call of ``fn`` launches (warm)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / 1e3


def group_norm_channels_last_ops(device):
    """The device kernels of ``F.group_norm`` on a channels-last bf16 tensor."""
    from torch.profiler import ProfilerActivity, profile

    x, weight, bias, _ = operands(3, 64, 96, 320, device)
    F.group_norm(x, 16, weight, bias)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        F.group_norm(x, 16, weight, bias)
        torch.cuda.synchronize()
    return [(e.key, e.count, round(e.device_time_total, 1))
            for e in prof.key_averages() if e.device_time_total > 0]


if __name__ == '__main__':
    dev = torch.device('cuda')
    out = {'device': torch.cuda.get_device_name(0),
           'group_norm_channels_last': group_norm_channels_last_ops(dev),
           'rows': group_norm_times(dev)}
    print(json.dumps(out['group_norm_channels_last']))
    per_pass = collections.Counter((3, *s) for s in group_norm_shapes(FULL, 384, 1280))
    out['pass'] = {k: sum(r[k] * per_pass[tuple(r['shape'])] for r in out['rows'])
                   for k in out['rows'][0] if k.endswith('_ms')}
    print('PackNet01 FULL pass, 47 GroupNorms:', json.dumps(out['pass']))
    with open(sys.argv[1], 'w') as f:
        json.dump(out, f, indent=1)
