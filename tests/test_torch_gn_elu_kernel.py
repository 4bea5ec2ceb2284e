"""The NHWC path of the bf16 depth networks on the CPU: the GroupNorm + ELU
kernel pair's arithmetic (``ops/cuda/gn_elu_kernel``: the autograd Function
with ``plain_forward`` and ``plain_backward`` in the kernels' place) against
autograd of ``F.elu(F.group_norm(x))`` in fp64; the layout rule
``ops/blocks.nhwc`` as a pure function; the NHWC pack and unpack against
``pixel_unshuffle`` / ``pixel_shuffle``; the decoder's join; and PackNet01
and PackNet-SAN with the rule forced on, the kernels replaced by their plain
versions, keeping every conv's input channels-last and computing what the
NCHW networks compute.  The kernels themselves run only on the card
(tests/test_torch_gn_elu_kernel_cuda.py).
"""

import pytest
import torch
import torch.nn.functional as F

from mindtheedge_tpu_torch.models import packnet
from mindtheedge_tpu_torch.ops import blocks, packing
from mindtheedge_tpu_torch.ops.cuda import conv3d_kernel, gn_elu_kernel
from mindtheedge_tpu_torch.parallel import spatial

torch.set_num_threads(1)

CL = torch.channels_last


@pytest.fixture
def plain_kernels(monkeypatch):
    """The plain versions in the kernels' places: ``GroupNormEluFn`` and
    ``Conv3dOverChannelsFn`` compute on the CPU, the 3-D conv's output in
    its input's layout as the kernel writes it."""
    monkeypatch.setattr(gn_elu_kernel, 'launch', gn_elu_kernel.plain_forward)
    monkeypatch.setattr(gn_elu_kernel, 'launch_backward', gn_elu_kernel.plain_backward)

    def conv3d_launch(x, weight, bias):
        y = conv3d_kernel.plain(x, weight, bias)
        return y.contiguous(memory_format=CL) if packing.channels_last(x) else y

    monkeypatch.setattr(conv3d_kernel, 'launch', conv3d_launch)


def operands(b, c, h, w, dtype, layout, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, c, h, w, generator=gen) * 2 + 0.5).to(dtype)
    weight = (1 + 0.5 * torch.randn(c, generator=gen)).to(dtype)
    bias = (0.3 * torch.randn(c, generator=gen)).to(dtype)
    grad = torch.randn(b, c, h, w, generator=gen).to(dtype)
    return x.contiguous(memory_format=layout), weight, bias, grad.contiguous(memory_format=layout)


def gradients(fn, x, weight, bias, grad):
    leaves = [t.detach().clone().requires_grad_() for t in (x, weight, bias)]
    y = fn(*leaves)
    y.backward(grad)
    return y, [t.grad for t in leaves]


@pytest.mark.parametrize('layout', [CL, torch.contiguous_format], ids=['nhwc', 'nchw'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('channels', [16, 32, 64, 256])
def test_function_arithmetic_against_group_norm_elu(plain_kernels, channels, dtype, layout):
    """Forward and backward of the Function equal autograd of
    ``F.elu(F.group_norm(x))`` computed in fp64 on the same operands: to
    fp32's rounding in fp32, and to within one rounding of the result in
    bf16 (the kernels round y, dx and the affine gradients once)."""
    x, weight, bias, grad = operands(2, channels, 7, 9, dtype, layout)
    y, got = gradients(lambda *t: gn_elu_kernel.GroupNormEluFn.apply(*t, 1e-5),
                       x, weight, bias, grad)
    want_y, want = gradients(lambda *t: gn_elu_kernel.plain(*t, 1e-5),
                             *(t.double() for t in (x, weight, bias, grad)))
    rtol, scale = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -8, 2 ** -8)
    for g, w in zip([y] + got, [want_y] + want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.double(), w, rtol=rtol, atol=scale * float(w.detach().abs().max()))


@pytest.mark.parametrize('dtype,device,space,expected', [
    (torch.bfloat16, 'cuda', None, True),
    (torch.bfloat16, torch.device('cuda', 1), None, True),
    (torch.float32, 'cuda', None, False),
    (torch.float16, 'cuda', None, False),
    (torch.bfloat16, 'cpu', None, False),
    (torch.bfloat16, 'cuda', object(), False),
], ids=['bf16-cuda', 'bf16-cuda1', 'fp32-cuda', 'fp16-cuda', 'bf16-cpu', 'bf16-cuda-sharded'])
def test_layout_rule(dtype, device, space, expected):
    assert blocks.nhwc(dtype, device, space) is expected
    assert blocks.weight_format(dtype, device, space) == (CL if expected else
                                                          torch.contiguous_format)


@pytest.mark.parametrize('net_cls', [packnet.PackNet01, packnet.PackNetSAN],
                         ids=['packnet01', 'packnet_san'])
def test_weights_follow_the_network_layout(monkeypatch, net_cls):
    """With the rule forced on, ``lay_out_weights`` lays every 4-D weight
    out channels-last, sharding lays them out NCHW and records the space
    on the network (what the training step's casts read), and unsharding
    restores both; values never change."""
    monkeypatch.setattr(blocks, 'nhwc', lambda dtype, device, space=None: space is None)
    net = packnet.init_weights(net_cls(channels=(16,) * 6), 0)
    values = {n: p.detach().clone() for n, p in net.named_parameters()}
    weights = lambda: [p for p in net.parameters() if p.dim() == 4]
    assert blocks.lay_out_weights(net) is net
    assert all(p.is_contiguous(memory_format=CL) for p in weights())
    space = spatial.Space(1)
    spatial.shard_network(net, space)
    assert net.space is space and all(p.is_contiguous() for p in weights())
    spatial.shard_network(net, None)
    assert net.space is None and all(p.is_contiguous(memory_format=CL) for p in weights())
    for n, p in net.named_parameters():
        assert torch.equal(p, values[n]), n


def test_groupnorm_elu_on_the_cpu_is_aten_and_launches_nothing():
    norm = blocks.GroupNorm(32).to(torch.bfloat16)
    x, *_ = operands(2, 32, 5, 6, torch.bfloat16, CL)
    before = gn_elu_kernel.launches
    assert torch.equal(norm.elu(x), F.elu(norm(x)))
    assert gn_elu_kernel.launches == before


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('shape', [(2, 6, 8, 12), (1, 32, 4, 6), (3, 1, 6, 2)],
                         ids=['2x6x8x12', '1x32x4x6', '3x1x6x2'])
@pytest.mark.parametrize('r', [2, 4])
def test_nhwc_pack_unpack_equal_pixel_shuffle(shape, dtype, r):
    b, c, h, w = shape
    x = torch.randn(b, c, h * r // 2, w * r // 2).to(dtype).contiguous(memory_format=CL)
    packed = packing.pack2d_nhwc(x, r)
    assert torch.equal(packed, F.pixel_unshuffle(x.contiguous(), r))
    assert packed.is_contiguous(memory_format=CL)
    unpacked = packing.unpack2d_nhwc(packed, r)
    assert torch.equal(unpacked, F.pixel_shuffle(packed.contiguous(), r))
    assert torch.equal(unpacked, x) and unpacked.is_contiguous(memory_format=CL)
    # the dispatch keeps each layout
    assert packing.channels_last(packing.pack2d(x, r)) == packing.channels_last(x)
    nchw = x.contiguous()
    assert packing.pack2d(nchw, r).is_contiguous() and packing.unpack2d(
        packing.pack2d(nchw, r), r).is_contiguous()


def test_decoder_join_stays_channels_last_beside_a_one_channel_map():
    """``torch.cat`` of channels-last maps and a 1-channel map whose strides
    read NCHW returns NCHW; the join concatenates the NHWC views."""
    dec = packnet.PackNetDecoder((16,) * 6)
    unpacked = torch.randn(2, 16, 6, 8).contiguous(memory_format=CL)
    skip = torch.randn(2, 16, 6, 8).contiguous(memory_format=CL)
    inv = torch.rand(2, 1, 6, 8)
    joined = dec._join(unpacked, skip, inv)
    assert packing.channels_last(joined)
    assert torch.equal(joined, torch.cat([unpacked, skip, inv], 1))
    assert dec._join(unpacked.contiguous(), skip.contiguous(), inv).is_contiguous()


def network_pass(net, rgb, lidar, forced, monkeypatch):
    """One training forward and backward of ``net`` -> (inverse depths, the
    parameters' gradients, conv inputs that were not channels-last); with
    ``forced`` the rule holds on the CPU and the weights are cast
    channels-last as the bf16 step casts them."""
    misses = []
    conv2d = F.conv2d

    def checked_conv2d(x, *args, **kwargs):
        if x.shape[1] > 1 and not packing.channels_last(x):
            misses.append(tuple(x.shape))
        return conv2d(x, *args, **kwargs)

    with monkeypatch.context() as m:
        if forced:
            m.setattr(blocks, 'nhwc', lambda dtype, device, space=None: space is None)
            m.setattr(blocks.Conv3dOverChannels, 'forward', lambda self, x:
                      conv3d_kernel.Conv3dOverChannelsFn.apply(x, self.weight, self.bias))
            m.setattr(F, 'conv2d', checked_conv2d)
        params = {n: p.contiguous(memory_format=CL) if forced and p.dim() == 4 else p
                  for n, p in net.named_parameters()}
        inv = torch.func.functional_call(net, params, (rgb, lidar))['inv_depths']
        loss = sum((d ** 2).mean() for d in inv)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return [d.detach() for d in inv], grads, misses


@pytest.mark.parametrize('net_cls', [packnet.PackNet01, packnet.PackNetSAN],
                         ids=['packnet01', 'packnet_san'])
def test_network_keeps_channels_last(plain_kernels, monkeypatch, net_cls):
    """With the rule forced on (fp32 on the CPU), every conv of both passes'
    layers reads a channels-last input: the residual adds, the dropout,
    the pack and unpack shuffles, the 3-D convs, the decoder's joins and the
    SAN ladder keep the layout; and the inverse depths and gradients are
    the NCHW network's."""
    torch.manual_seed(0)
    net = packnet.init_weights(net_cls(channels=(16,) * 6, dropout=0.5), 0).train()
    gen = torch.Generator().manual_seed(1)
    rgb = torch.rand(2, 64, 96, 3, generator=gen)
    lidar = None
    if net_cls is packnet.PackNetSAN:
        lidar = torch.rand(2, 64, 96, 1, generator=gen) * 80
        lidar = lidar * (torch.rand(2, 64, 96, 1, generator=gen) < 0.1)
    torch.manual_seed(2)
    want = network_pass(net, rgb, lidar, False, monkeypatch)
    torch.manual_seed(2)
    got = network_pass(net, rgb, lidar, True, monkeypatch)
    assert got[2] == []
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    largest = max(float(w.norm()) for w in want[1] if w is not None)
    for (name, _), g, w in zip(net.named_parameters(), got[1], want[1]):
        assert (g is None) == (w is None), name
        # conv biases before one-channel groups have gradients of rounding noise
        if w is not None and float(w.norm()) > 1e-4 * largest:
            assert float((g - w).norm() / w.norm()) < 1e-3, name
