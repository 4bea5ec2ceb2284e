"""The PackNet variants of the port (mindtheedge_tpu_torch/models/packnet.py)
against the JAX package's: PackNet-SAN with the 4-channel ``rgb_edge``
input (1A, with and without LiDAR), PackNet-SAN 1B, ``PackNet01`` 1A and
1B and ``PackNetSlim01``; the eval forward and both training outputs
(``inv_depths``, ``inv_depths_rgbd``, ``depth_loss``), and the refusal of
version B at widths whose skips cannot add.

64x96, batch 2, channels (16,)*6 (the JAX blocks need 16 channels a
GroupNorm group of phase quads), except ``PackNetSlim01``, whose own
``SLIM_CHANNELS`` are the point of it, at 32x64.  The JAX weights are
perturbed and carried over by ``utils/weights.state_dict_from_jax``.
Tolerance rtol 1e-4, atol 1e-5 on every scale and on ``depth_loss``:
fp32, the two sides sum conv taps and GroupNorm moments in different
orders.  Dropout is off (its draws cannot match JAX's).
"""

import numpy as np
import jax
import pytest
import torch

from mindtheedge_tpu.models import packnet as jpacknet
from mindtheedge_tpu_torch.models import packnet
from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_blocks import perturb

torch.set_num_threads(1)

CHANNELS = (16,) * 6
RTOL, ATOL = 1e-4, 1e-5

# name: (JAX module, port module, input_channels, LiDAR, (H, W))
CASES = {
    'san_rgb_edge_lidar': (lambda: jpacknet.PackNetSAN(input_channels=4, channels=CHANNELS),
                           lambda: packnet.PackNetSAN(CHANNELS, input_channels=4),
                           4, True, (64, 96)),
    'san_rgb_edge': (lambda: jpacknet.PackNetSAN(input_channels=4, channels=CHANNELS),
                     lambda: packnet.PackNetSAN(CHANNELS, input_channels=4),
                     4, False, (64, 96)),
    'san_1B_lidar': (lambda: jpacknet.PackNetSAN(version='1B', channels=CHANNELS),
                     lambda: packnet.PackNetSAN(CHANNELS, version='1B'),
                     3, True, (64, 96)),
    'packnet01_1A': (lambda: jpacknet.PackNet01(channels=CHANNELS),
                     lambda: packnet.PackNet01(CHANNELS), 3, False, (64, 96)),
    'packnet01_1B': (lambda: jpacknet.PackNet01(version='1B', channels=CHANNELS),
                     lambda: packnet.PackNet01(CHANNELS, version='1B'), 3, False, (64, 96)),
    'packnet_slim01': (lambda: jpacknet.PackNetSlim01(), lambda: packnet.PackNetSlim01(),
                       3, False, (32, 64)),
}


def inputs(shape, seed=1, batch=2):
    """rgb [B,H,W,3], LiDAR [B,H,W,1] 95 % empty, rgb_edge [B,H,W,1] in
    [0, 1]."""
    h, w = shape
    rng = np.random.RandomState(seed)
    rgb = rng.rand(batch, h, w, 3).astype(np.float32)
    lidar = rng.rand(batch, h, w, 1).astype(np.float32) * 80.0
    lidar[rng.rand(batch, h, w, 1) < 0.95] = 0.0
    edge = rng.rand(batch, h, w, 1).astype(np.float32)
    return rgb, lidar, edge


@pytest.fixture(scope='module', params=list(CASES))
def pair(request):
    make_jax, make_port, in_ch, with_lidar, shape = CASES[request.param]
    rgb, lidar, edge = inputs(shape)
    kwargs = {'input_depth': lidar if with_lidar else None,
              'rgb_edge': edge if in_ch == 4 else None}
    jmodel = make_jax()
    # the SAN ladder's parameters exist once it has run: init with LiDAR
    variables = jax.jit(lambda k, r, kw: jmodel.init(k, r, train=False, **kw))(
        jax.random.PRNGKey(0), rgb, dict(kwargs, input_depth=lidar))
    variables = perturb(jax.tree_util.tree_map(np.asarray, variables),
                        np.random.RandomState(0))
    model = make_port()
    model.load_state_dict(state_dict_from_jax(variables['params'],
                                              variables.get('batch_stats')), strict=True)
    return dict(jmodel=jmodel, variables=variables, model=model, rgb=rgb,
                kwargs=kwargs, shape=shape, name=request.param)


def port_forward(pair, train):
    t = lambda a: None if a is None else torch.from_numpy(a)
    net = pair['model'].train(train)
    with torch.set_grad_enabled(False):
        return net(t(pair['rgb']), t(pair['kwargs']['input_depth']),
                   rgb_edge=t(pair['kwargs']['rgb_edge']))


def assert_scales_close(got, want, shape, what):
    h, w = shape
    assert len(got) == len(want) == 4, what
    for s, (g, wt) in enumerate(zip(got, want)):
        assert tuple(g.shape) == wt.shape == (2, h >> s, w >> s, 1), (what, s)
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=RTOL, atol=ATOL,
                                   err_msg=f'{what} scale {s}')


def test_eval_forward_matches_jax(pair):
    """All 4 scales; the 4-channel network's scale 0 times ``rgb_edge``."""
    jmodel, variables = pair['jmodel'], pair['variables']
    want = jax.jit(lambda v, r, kw: jmodel.apply(v, r, train=False, **kw))(
        variables, pair['rgb'], pair['kwargs'])
    got = port_forward(pair, train=False)
    assert set(got) == set(want) == {'inv_depths'}
    assert_scales_close(got['inv_depths'], want['inv_depths'], pair['shape'], 'eval')


def test_training_outputs_match_jax(pair):
    """The RGB pass and, with LiDAR, the RGBD pass and ``depth_loss``."""
    jmodel, variables = pair['jmodel'], pair['variables']
    mutable = ['batch_stats'] if 'batch_stats' in variables else []
    want, _ = jax.jit(lambda v, r, kw: jmodel.apply(
        v, r, train=True, mutable=mutable, **kw))(variables, pair['rgb'], pair['kwargs'])
    got = port_forward(pair, train=True)
    assert set(got) == set(want)
    for key in ('inv_depths', 'inv_depths_rgbd'):
        if key in want:
            assert_scales_close(got[key], want[key], pair['shape'], key)
    if 'depth_loss' in want:
        np.testing.assert_allclose(float(got['depth_loss']), float(want['depth_loss']),
                                   rtol=RTOL, atol=ATOL)


def test_rgb_edge_reaches_the_network():
    """The 4-channel input is read in every pass (a zero map changes every
    scale, not only scale 0's multiply), and a missing map raises."""
    torch.manual_seed(0)
    net = packnet.init_weights(packnet.PackNetSAN(CHANNELS, input_channels=4), 0).eval()
    rgb, _, edge = (torch.from_numpy(a) for a in inputs((64, 96)))
    with torch.no_grad():
        a = net(rgb, rgb_edge=edge)['inv_depths']
        b = net(rgb, rgb_edge=torch.ones_like(edge))['inv_depths']
    assert all(not torch.allclose(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match='rgb_edge'):
        net(rgb)


@pytest.mark.parametrize('name', ['PackNetSAN', 'PackNet01'])
def test_version_b_at_published_widths_is_refused(name):
    """At the published widths version B adds an unpack output of one width
    to a skip of another: the JAX package fails at its first forward (a
    TypeError from the add), the port refuses at construction with a
    ValueError that states the condition."""
    channels = jpacknet.SLIM_CHANNELS if name == 'PackNetSAN' else jpacknet.FULL_CHANNELS
    rgb = np.zeros((1, 64, 96, 3), np.float32)
    jmodel = getattr(jpacknet, name)(version='1B', channels=channels)
    with pytest.raises(TypeError, match='incompatible shapes'):
        jax.jit(lambda k, r: jmodel.init(k, r, train=False))(jax.random.PRNGKey(0), rgb)
    with pytest.raises(ValueError, match='every width must be equal'):
        getattr(packnet, name)(channels, version='1B')
    assert packnet.FULL_CHANNELS == jpacknet.FULL_CHANNELS


@pytest.mark.parametrize('name,version,input_channels,channels', [
    ('PackNetSAN01', '1A', 4, CHANNELS), ('PackNetSAN01', '1B', 3, CHANNELS),
    ('PackNet01', '1B', 3, CHANNELS), ('PackNetSlim01', '1A', 3, ()),
    ('RaySurfaceResNet', '', 3, ())])
def test_restore_depth_net_from_jax_checkpoint(tmp_path, name, version, input_channels,
                                               channels):
    """``training/checkpoint.restore_depth_net`` loads every entry of each
    network from a checkpoint the JAX package saved: the 4-channel stem,
    version B's iconvs, trees without the SAN ladder, and
    ``RaySurfaceResNet``'s ``ray_surf`` decoder with its batch statistics."""
    import types
    import optax
    from mindtheedge_tpu import config as jconfig
    from mindtheedge_tpu.models import tasks as jtasks
    from mindtheedge_tpu.training.checkpoint import save_checkpoint
    from mindtheedge_tpu.training.state import split_variables
    from mindtheedge_tpu_torch import config
    from mindtheedge_tpu_torch.models import tasks
    from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint, restore_depth_net
    from mindtheedge_tpu_torch.utils.weights import depth_state_dict_from_jax
    cfg = jconfig.get_cfg_defaults()
    cfg.model.name = 'SfmModel'
    node = cfg.model.depth_net
    node.name, node.version, node.input_channels = name, version, input_channels
    node.channels = channels
    rgb, lidar, edge = inputs((64, 96), batch=1)
    variables = jax.jit(jtasks.build_task(cfg).init)(
        jax.random.PRNGKey(0), {'rgb': rgb, 'input_depth': lidar, 'rgb_edge': edge})
    params, stats = split_variables({'depth': perturb(
        jax.tree_util.tree_map(np.asarray, variables['depth']), np.random.RandomState(2))})
    state = types.SimpleNamespace(
        epoch=1, step=1, params=params, batch_stats=stats,
        opt_state=jax.tree_util.tree_map(np.asarray, optax.adam(1e-3).init(params)))
    save_checkpoint(str(tmp_path / 'jax.ckpt'), cfg, state)
    port_cfg = config.get_cfg_defaults()
    port_cfg.merge_from_other_cfg(cfg.to_dict())
    net = tasks.build_depth_net(port_cfg.model.depth_net)
    restore_depth_net(net, load_checkpoint(str(tmp_path / 'jax.ckpt')))
    counted = lambda sd: {k: v for k, v in sd.items() if not k.endswith('num_batches_tracked')}
    want = counted(depth_state_dict_from_jax(params['depth'], stats.get('depth')))
    got = counted(net.state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_packnet01_takes_the_spatial_seams():
    """``parallel/spatial.shard_network`` takes ``PackNet01`` (its blocks
    are PackNet-SAN's): its forward through the sharded code path at a
    space of one (zero-pad exchanges, two-pass GroupNorm statistics)
    equals its plain forward within rtol 1e-4, atol 1e-5; a ResNet has no
    such blocks and raises."""
    from mindtheedge_tpu_torch.models.resnet import RaySurfaceResNet
    from mindtheedge_tpu_torch.parallel import spatial
    net = packnet.init_weights(packnet.PackNet01(CHANNELS, version='1B'), 0).eval()
    rgb = inputs((64, 96))[0]
    torch_rgb = torch.from_numpy(rgb)
    with torch.no_grad():
        want = net(torch_rgb)['inv_depths']
        got = spatial.make_spatial_infer(net, spatial.Space(1))(torch_rgb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match='no spatial support'):
        spatial.shard_network(RaySurfaceResNet(), spatial.Space(1))
