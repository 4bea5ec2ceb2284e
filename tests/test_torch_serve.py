"""The port's serving path (mindtheedge_tpu_torch/serve.py) against the body of
__graft_entry__.entry()'s forward, rebuilt here at 64x96 and channels (16,)*6:
PackNetSAN.apply, inv2depth, clip(inv/2), edge_ops.non_max_suppression.

Tolerances: depth rtol 1e-3 (the network's fp32 tolerance,
tests/test_full_network_parity.py).  Edges agree on >= 99 % of pixels: ulp
differences in the inverse depth flip NMS near-ties.  Fed the same
probability map, the NMS agrees exactly; the wire codecs agree exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mindtheedge_tpu.models.packnet import PackNetSAN as JaxPackNetSAN
from mindtheedge_tpu.ops import edge_ops as jedge
from mindtheedge_tpu.ops import wire as jwire
from mindtheedge_tpu.utils.depth import inv2depth as jinv2depth
from mindtheedge_tpu_torch import resolve_device, serve
from mindtheedge_tpu_torch.models.packnet import PackNetSAN
from mindtheedge_tpu_torch.ops import wire
from mindtheedge_tpu_torch.ops.cuda import nms_kernel
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_blocks import perturb

torch.set_num_threads(1)

CHANNELS = (16,) * 6
H, W = 64, 96


@pytest.fixture(scope='module')
def pair():
    rng = np.random.RandomState(0)
    rgb_u8 = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    lidar = rng.rand(2, H, W, 1).astype(np.float32) * 80.0
    lidar[rng.rand(2, H, W, 1) < 0.95] = 0.0
    jmodel = JaxPackNetSAN(version='1A', channels=CHANNELS)
    variables = jax.jit(lambda k, r, d: jmodel.init(k, r, d, train=False))(
        jax.random.PRNGKey(0), rgb_u8.astype(np.float32), lidar)
    variables = perturb(jax.tree_util.tree_map(np.asarray, variables), rng)

    @jax.jit
    def forward(variables, rgb_u8, lidar):
        rgb = rgb_u8.astype(jnp.float32) / 255.0
        out = jmodel.apply(variables, rgb, lidar, train=False)
        inv_depth = out['inv_depths'][0][..., 0]
        prob = jnp.clip(inv_depth / 2.0, 0.0, 1.0)
        return jinv2depth(inv_depth), jedge.non_max_suppression(prob), prob

    depth, edges, prob = (np.array(a) for a in forward(
        variables, rgb_u8, lidar))
    model = PackNetSAN(CHANNELS).eval()
    model.load_state_dict(state_dict_from_jax(
        variables['params'], variables['batch_stats']), strict=True)
    return dict(model=model, rgb_u8=rgb_u8, lidar=lidar, depth=depth,
                edges=edges, prob=prob)


def test_depth_edges_matches_jax(pair):
    rgb = torch.from_numpy(pair['rgb_u8']).float() / 255.0
    out = serve.depth_edges(pair['model'], rgb, torch.from_numpy(pair['lidar']))
    np.testing.assert_allclose(out['depth'].numpy(), pair['depth'], rtol=1e-3)
    got, want = out['edges'].numpy(), pair['edges']
    agree = ((got > 0) == (want > 0)).mean()
    assert agree >= 0.99, f'{agree:.5f} of edge pixels agree'
    both = (got > 0) & (want > 0)
    np.testing.assert_allclose(got[both], want[both], rtol=1e-3)


def test_nms_on_jax_probability_exact(pair):
    got = nms_kernel.non_max_suppression(torch.from_numpy(pair['prob']))
    np.testing.assert_array_equal(got.numpy(), pair['edges'])


@pytest.mark.parametrize('fmt', ['u16', 'u8'])
def test_serve_matches_jax_wire(pair, fmt):
    enc = {'u16': jwire.encode_depth_u16, 'u8': jwire.encode_depth_u8}[fmt]
    want_depth = np.asarray(enc(jnp.asarray(pair['depth'])))
    want_edges = np.asarray(jwire.pack_edges(jnp.asarray(pair['edges'] > 0.5)))
    depth, edges = serve.serve(pair['model'], torch.from_numpy(pair['rgb_u8']),
                               torch.from_numpy(pair['lidar']), wire=fmt)
    assert depth.dtype == {'u16': torch.uint16, 'u8': torch.uint8}[fmt]
    assert depth.shape == (2, H, W) and edges.shape == (2, H, W // 8)
    # one quantisation step: the fp32 depths differ by rtol 1e-3 at most
    assert np.abs(depth.numpy().astype(np.int64) - want_depth).max() <= 1
    bits = wire.unpack_edges(edges).numpy()
    assert (bits == np.unpackbits(want_edges, axis=-1)).mean() >= 0.99


def test_wire_codecs_match_jax():
    rng = np.random.RandomState(1)
    edges = (rng.rand(3, 48, 160) > 0.7).astype(np.uint8)
    packed = wire.pack_edges(torch.from_numpy(edges))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jwire.pack_edges(jnp.asarray(edges))))
    np.testing.assert_array_equal(wire.unpack_edges(packed).numpy(), edges)
    with pytest.raises(ValueError):
        wire.pack_edges(torch.zeros(1, 4, 13))

    depth = rng.rand(2, 32, 40).astype(np.float32) * 90.0
    depth[0, 0, :3] = (-1.0, 0.0, 300.0)          # both clip limits
    for fmt in ('u16', 'u8'):
        enc = getattr(wire, f'encode_depth_{fmt}')
        dec = getattr(wire, f'decode_depth_{fmt}')
        jenc = np.asarray(getattr(jwire, f'encode_depth_{fmt}')(
            jnp.asarray(depth)))
        got = enc(torch.from_numpy(depth))
        np.testing.assert_array_equal(got.numpy(), jenc)
        np.testing.assert_array_equal(
            dec(got).numpy(), getattr(jwire, f'decode_depth_{fmt}')(jenc))


def test_build_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serve.build(CHANNELS)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')


def test_build_on_cpu_is_seeded():
    a = serve.build(CHANNELS, device='cpu', seed=0)
    b = serve.build(CHANNELS, device='cpu', seed=0)
    c = serve.build(CHANNELS, device='cpu', seed=1)
    assert not a.training
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    key = 'encoder.pre_calc.conv_base.weight'
    assert not torch.equal(sa[key], sc[key])
    rng = np.random.RandomState(2)
    rgb_u8 = torch.from_numpy(rng.randint(0, 256, (1, 32, 64, 3)).astype(np.uint8))
    depth, edges = serve.serve(a, rgb_u8, torch.zeros(1, 32, 64, 1))
    assert depth.dtype == torch.uint16 and depth.shape == (1, 32, 64)
    assert edges.dtype == torch.uint8 and edges.shape == (1, 32, 8)
