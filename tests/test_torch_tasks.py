"""The port's eval tasks (mindtheedge_tpu_torch/models/tasks.py) against the
JAX package's (mindtheedge_tpu/models/tasks.py).

The JAX task is initialised, its weights perturbed, and written as the JAX
package's own checkpoint; the port builds its task from that file.  64x96,
channels (16,)*6, batch 2, all 4 scales at rtol 1e-3, atol 1e-5: fp32
through ~40 conv layers whose taps the two sides sum in different orders
(tests/test_torch_packnet.py).

It also pins the LiDAR /200 split: ``EdgeEstimationLIDARTask.infer``
divides the LiDAR by 200 and halves every scale; ``run_depth`` does
neither, because the annotation CLI divides when it reads the LiDAR.
"""

import types

import numpy as np
import jax
import optax
import pytest
import torch

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.training.checkpoint import save_checkpoint
from mindtheedge_tpu.training.state import split_variables
from mindtheedge_tpu_torch import config
from mindtheedge_tpu_torch.cli.infer_edge_estimation import annotate_batch
from mindtheedge_tpu_torch.models import tasks
from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint
from tests.test_torch_blocks import perturb

torch.set_num_threads(1)

CHANNELS = (16,) * 6   # the JAX blocks need 16: GroupNorm over phase quads
H, W = 64, 96
RTOL, ATOL = 1e-3, 1e-5


def model_config(model_name, channels=CHANNELS):
    """The JAX package's config tree for a PackNet-SAN 1A task."""
    cfg = jconfig.get_cfg_defaults()
    cfg.name = 'ckpt-run'
    cfg.model.name = model_name
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.version = '1A'
    cfg.model.depth_net.channels = tuple(channels)
    return cfg


def write_jax_checkpoint(path, model_name, channels=CHANNELS, seed=0):
    """Initialise the JAX task, perturb its constant-initialised leaves and
    save it with ``training/checkpoint.save_checkpoint``, Adam state
    included -> (JAX task, its variables, the config)."""
    cfg = model_config(model_name, channels)
    jtask = jtasks.build_task(cfg)
    rng = np.random.RandomState(seed)
    sample = {'rgb': np.zeros((1, H, W, 3), np.float32),
              'input_depth': np.zeros((1, H, W, 1), np.float32)}
    variables = jax.jit(jtask.init)(jax.random.PRNGKey(seed), sample)
    variables = {'depth': perturb(jax.tree_util.tree_map(
        np.asarray, variables['depth']), rng)}
    params, stats = split_variables(variables)
    state = types.SimpleNamespace(
        epoch=3, step=30, params=params, batch_stats=stats,
        opt_state=jax.tree_util.tree_map(np.asarray, optax.adam(1e-3).init(params)))
    save_checkpoint(str(path), cfg, state)
    return jtask, variables, cfg


def inputs(seed=1, batch=2):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(batch, H, W, 3).astype(np.float32)
    lidar = rng.rand(batch, H, W, 1).astype(np.float32) * 80.0
    lidar[rng.rand(batch, H, W, 1) < 0.95] = 0.0
    return rgb, lidar


def assert_scales_close(got, want):
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape == (w.shape[0], H >> s, W >> s, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f'scale {s}')


@pytest.fixture(scope='module', params=['EdgeEstimationLIDARModel', 'SemiSupEdgeModel'])
def pair(request, tmp_path_factory):
    path = tmp_path_factory.mktemp('ckpt') / 'jax.ckpt'
    jtask, variables, jcfg = write_jax_checkpoint(path, request.param)
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    task = tasks.build_task(cfg, device='cpu', ckpt=load_checkpoint(str(path)))
    return jtask, variables, task


@pytest.mark.parametrize('with_lidar', [True, False], ids=['lidar', 'rgb'])
@pytest.mark.parametrize('method', ['infer', 'run_depth', 'infer_flipped'])
def test_task_matches_jax(pair, method, with_lidar):
    jtask, variables, task = pair
    rgb, lidar = inputs()
    batch = {'rgb': rgb, **({'input_depth': lidar} if with_lidar else {})}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if method == 'run_depth':
        want = jax.jit(lambda v, b: jtask.run_depth(v, b, train=False)[0])(
            variables, batch)
        got = task.run_depth(tbatch)
    else:
        flip = method == 'infer_flipped'
        want = jax.jit(lambda v, b: jtask.infer(v, b, force_flip=flip))(
            variables, batch)
        got = task.infer(tbatch, force_flip=flip)
    assert_scales_close(got['inv_depths'], want['inv_depths'])


@pytest.mark.parametrize('pair', ['EdgeEstimationLIDARModel'], indirect=True)
def test_lidar_divided_by_200_once(pair):
    """infer(lidar) == run_depth(lidar / 200) halved, and the annotation
    path (run_depth on LiDAR divided when read) gives the same edge
    probability; without the division the output differs."""
    task = pair[2]
    assert isinstance(task, tasks.EdgeEstimationLIDARTask)
    rgb, lidar = (torch.from_numpy(a) for a in inputs())
    inferred = task.infer({'rgb': rgb, 'input_depth': lidar})['inv_depths']
    run = task.run_depth({'rgb': rgb, 'input_depth': lidar / 200.0})['inv_depths']
    raw = task.run_depth({'rgb': rgb, 'input_depth': lidar})['inv_depths']
    annotated = annotate_batch(task, rgb, lidar / 200.0, nms=False, hyst=False,
                               normals=False)
    for s in range(4):
        assert torch.equal(inferred[s], run[s] / 2.0)
        assert torch.equal(annotated[s]['edge'], inferred[s][..., 0])
        assert not torch.allclose(raw[s], run[s], rtol=1e-3)


def test_unported_options_raise():
    """Every option of the JAX package's registries builds, and nothing is
    refused as unported any more: the 4-channel input, version 1B,
    ``PackNet01`` / ``PackNetSlim01``, ``RaySurfaceResNet`` and the generic
    tasks.  An unknown model still raises a KeyError, and the photometric
    loss without a pose network a ValueError before any work."""
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(model_config('SemiSupEdgeModel').to_dict())
    for changes in ((('model.depth_net.input_channels', 4),),
                    (('model.depth_net.version', '1B'),),
                    (('model.depth_net.name', 'PackNet01'),),
                    (('model.depth_net.name', 'PackNetSlim01'), ('model.depth_net.channels', ())),
                    (('model.depth_net.name', 'RaySurfaceResNet'),
                     ('model.depth_net.version', '')),
                    (('model.name', 'GenericSfmModel'),
                     ('model.depth_net.name', 'RaySurfaceResNet'),
                     ('model.depth_net.version', '')),
                    (('model.name', 'GenericSelfSupModel'),
                     ('model.depth_net.name', 'RaySurfaceResNet'),
                     ('model.depth_net.version', ''), ('model.pose_net.name', 'PoseNet'))):
        ok = cfg.clone()
        for key, value in changes:
            ok.merge_from_list([key, value])
        task = tasks.build_task(ok, device='cpu')
        assert type(task) is tasks.TASK_REGISTRY[ok.model.name]
        assert type(task.depth_net).__name__ == {
            'PackNetSAN01': 'PackNetSAN'}.get(ok.model.depth_net.name, ok.model.depth_net.name)
    bad = cfg.clone()
    bad.model.name = 'NoSuchModel'
    with pytest.raises(KeyError, match='SelfSupModel'):
        tasks.build_task(bad, device='cpu')
    # the default supervised_loss_weight 0.9 runs the photometric loss,
    # which needs a pose network
    with pytest.raises(ValueError, match='model.pose_net.name'):
        tasks.build_task(cfg, device='cpu').check_trainable()
    dee = cfg.clone()
    dee.model.name = 'EdgeEstimationLIDARModel'
    tasks.build_task(dee, device='cpu').check_trainable()


def test_registries_match_the_jax_package():
    """The port builds every name of the JAX package's ``TASK_REGISTRY``,
    ``DEPTH_NET_REGISTRY`` and ``POSE_NET_REGISTRY``, each depth network as
    the class the JAX registry names (``PackNetSlimEnc01`` is PackNet-SAN,
    the checkpoint-name bypass)."""
    assert set(tasks.TASK_REGISTRY) == set(jtasks.TASK_REGISTRY)
    for name, jcls in jtasks.DEPTH_NET_REGISTRY.items():
        node = config.get_cfg_defaults().model.depth_net
        node.name = name
        assert type(tasks.build_depth_net(node)).__name__ == jcls.__name__, name
    for name in jtasks.POSE_NET_REGISTRY:
        node = config.get_cfg_defaults().model.pose_net
        node.name = name
        assert type(tasks.build_pose_net(node)).__name__ == name


def test_precision_and_remat_choices():
    """``arch.precision`` and ``model.depth_net.remat`` build with each of
    their values (``remat: 'conv'`` merges over the default False) and
    raise a ValueError naming the key for any other, at merge and at
    build."""
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(model_config('EdgeEstimationLIDARModel').to_dict())
    for precision, dtype in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
        for remat in (False, True, 'conv'):
            ok = cfg.clone()
            ok.merge_from_list(['arch.precision', precision, 'model.depth_net.remat', remat])
            task = tasks.build_task(ok, device='cpu')
            assert task.compute_dtype == dtype and task.depth_net.remat == remat
            assert all(p.dtype == torch.float32 for p in task.depth_net.parameters())
    for key, value in (('arch.precision', 'float16'), ('model.depth_net.remat', 'full'),
                       ('model.depth_net.remat', 1)):
        with pytest.raises(ValueError, match=key.replace('.', r'\.')):
            cfg.clone().merge_from_list([key, value])
        bad = cfg.clone()
        node = bad.arch if key.startswith('arch') else bad.model.depth_net
        setattr(node, key.rsplit('.', 1)[1], value)
        with pytest.raises(ValueError, match=key.replace('.', r'\.')):
            tasks.build_task(bad, device='cpu')


def test_build_task_without_cuda_raises(monkeypatch, tmp_path):
    """``device=None`` means the card: without one, the task and the CLIs
    raise instead of running on the CPU."""
    from mindtheedge_tpu_torch.cli import infer_edge_estimation
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(model_config('EdgeEstimationLIDARModel').to_dict())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tasks.build_task(cfg)
    path = tmp_path / 'cfg.yaml'
    cfg.save.folder = str(tmp_path / 'out')
    cfg.checkpoint.filepath = str(tmp_path / 'missing.ckpt')
    cfg.save_yaml(str(path))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        infer_edge_estimation.main(['--config', str(path)])
