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
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(model_config('SemiSupEdgeModel').to_dict())
    for key, value, item in (('model.depth_net.input_channels', 4, 'item 10'),
                             ('model.depth_net.version', '1B', 'item 10'),
                             ('model.depth_net.name', 'PackNet01', 'item 10'),
                             ('arch.precision', 'bfloat16', 'item 9')):
        bad = cfg.clone()
        bad.merge_from_list([key, value])
        with pytest.raises(NotImplementedError, match=item):
            tasks.build_task(bad, device='cpu')
    bad = cfg.clone()
    bad.model.name = 'SelfSupModel'
    with pytest.raises(KeyError, match='Slice C'):
        tasks.build_task(bad, device='cpu')
    task = tasks.build_task(cfg, device='cpu')
    with pytest.raises(NotImplementedError, match='Slice C'):
        task.train_loss({})


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
