"""The port's training CLI (``mindtheedge_tpu_torch.cli.train_edges.main``,
``device='cpu'``) against the JAX package's ``Experiment.fit`` on the same
split, config and starting weights:

* ``SemiSupEdgeModel`` (the paper's) and ``EdgeEstimationLIDARModel`` (DEE)
  for 2 epochs each on the synthetic GTA split of
  tests/make_synthetic_dataset;
* ``SemiSupModel`` at ``supervised_loss_weight`` 0.9 with ``PoseNet`` for 1
  epoch on the synthetic KITTI tree of ``test_torch_train_cuda.write_kitti_tree``, one back
  and one forward context frame, through ``KITTIDataset``.

4 frames at 64x96 (6 on the KITTI tree, 4 with full context), batch 2,
channels (16,)*6, StepLR every epoch, jitter off, dropout 0,
``flip_lr_prob`` 0.  Both sides start from one JAX-format checkpoint named
by ``model.depth_net.checkpoint_path``; the port reads the pose network's
from ``model.pose_net.checkpoint_path``, and the JAX side, which reads no
pose checkpoint, gets the same pose parameters set into its state before
``fit``.  The per-epoch mean losses agree within rtol 1e-2: one Adam step
already moves the few parameters whose gradient lies inside fp32 noise by
+-lr on either side (tests/test_torch_train_step.py).
"""

import json
import os
import re
import types

import numpy as np
import jax
import optax
import pytest
import torch

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.models import tasks as jtasks
from mindtheedge_tpu.training.checkpoint import save_checkpoint as jsave_checkpoint
from mindtheedge_tpu.training.experiment import Experiment as JaxExperiment
from mindtheedge_tpu.training.state import split_variables
from mindtheedge_tpu.utils.torch_port import port_packnet_san
from mindtheedge_tpu_torch import config
from mindtheedge_tpu_torch.cli import train_edges
from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint, restore_train_state
from mindtheedge_tpu_torch.training.experiment import Experiment
from mindtheedge_tpu_torch.training.train_step import create_train_state
from tests.test_torch_train_cuda import write_kitti_tree
from tests.make_synthetic_dataset import make_dataset
from tests.test_torch_blocks import perturb

torch.set_num_threads(1)

CHANNELS = (16,) * 6
H, W = 64, 96
LR = 1e-3


def train_config(split, ckpt_dir, init_ckpt, model='SemiSupEdgeModel'):
    """The JAX package's config of the run (``tests/test_end_to_end_training.py``
    at channels (16,)*6, deterministic)."""
    cfg = jconfig.get_cfg_defaults()
    cfg.name = 'synthetic'
    cfg.arch.max_epochs = 2
    cfg.arch.dp_devices = 1
    cfg.model.name = model
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.version = '1A'
    cfg.model.depth_net.channels = CHANNELS
    cfg.model.depth_net.checkpoint_path = init_ckpt
    cfg.model.loss.supervised_method = 'sparse-silog'
    cfg.model.loss.supervised_num_scales = 1
    cfg.model.loss.supervised_loss_weight = 1.0
    cfg.model.loss.edges_depth_edge_loss_all_scales = True
    cfg.model.loss.upsample_depth_maps = False
    cfg.model.loss.flip_lr_prob = 0.0
    cfg.model.optimizer.depth.lr = LR
    cfg.model.scheduler.step_size = 1
    cfg.model.scheduler.gamma = 0.5
    cfg.edges.train_depth_edges = True
    cfg.edges.depth_edges_metric_log = True
    cfg.datasets.augmentation.image_shape = (H, W)
    cfg.datasets.augmentation.jittering = ()
    for mode in ('train', 'validation'):
        ds = cfg.datasets[mode]
        ds.dataset, ds.path, ds.split = ['GTA'], [''], [split]
        ds.depth_type, ds.input_depth_type = ['groundtruth'], ['velodyne']
        ds.num_workers = 2
        ds.back_context = ds.forward_context = 0
    cfg.datasets.train.batch_size = 2
    cfg.checkpoint.filepath = ckpt_dir
    cfg.checkpoint.save_top_k = 1
    cfg.checkpoint.save_freq = 2
    return jconfig.prepare_config(cfg)


def write_init_checkpoint(path):
    """A JAX-format checkpoint of perturbed weights, SAN running statistics
    at their init values (the JAX trainer loads parameters only)."""
    jtask = jtasks.build_task(train_config('', '', ''))
    sample = {'rgb': np.zeros((1, H, W, 3), np.float32),
              'input_depth': np.zeros((1, H, W, 1), np.float32)}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jtask.init)(jax.random.PRNGKey(0), sample))
    params, stats = split_variables(variables)
    params = {'depth': perturb(params['depth'], np.random.RandomState(0))}
    state = types.SimpleNamespace(
        epoch=0, step=0, params=params, batch_stats=stats,
        opt_state=jax.tree_util.tree_map(np.asarray, optax.adam(1e-3).init(params)))
    jsave_checkpoint(str(path), train_config('', '', ''), state)
    return str(path)


def epoch_losses(ckpt_dir):
    with open(os.path.join(ckpt_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    return [r['train/loss'] for r in rows if 'train/loss' in r]


def shape_of(names):
    """Checkpoint names with their metric values blanked: ``epoch=NN`` and
    which metrics they carry."""
    return sorted(re.sub(r'(f1|loss)=[-0-9.]+', r'\1=*', n) for n in names)


def ckpts(ckpt_dir):
    return sorted(f for f in os.listdir(ckpt_dir) if f.endswith('.ckpt'))


def kitti_config(root, split, ckpt_dir, init_ckpt, pose_ckpt):
    """``SemiSupModel`` at w 0.9 with PoseNet on the KITTI tree: 1 epoch,
    one back and one forward context frame, ground-truth depth, no LiDAR;
    validation on the same frames."""
    cfg = train_config(split, ckpt_dir, init_ckpt, model='SemiSupModel')
    cfg.arch.max_epochs = 1
    cfg.model.loss.supervised_loss_weight = 0.9
    cfg.model.pose_net.name = 'PoseNet'
    cfg.model.pose_net.checkpoint_path = pose_ckpt
    cfg.edges.depth_edges_metric_log = False
    cfg.checkpoint.monitor = 'loss'
    for mode in ('train', 'validation'):
        ds = cfg.datasets[mode]
        ds.dataset, ds.path, ds.split = ['KITTI'], [root], [split]
        ds.input_depth_type = ['']
    cfg.datasets.train.back_context = cfg.datasets.train.forward_context = 1
    return jconfig.prepare_config(cfg)


def write_pose_checkpoint(path):
    """A JAX-format checkpoint holding perturbed PoseNet parameters alone."""
    from mindtheedge_tpu.models.posenet import PoseNet
    image = np.zeros((1, H, W, 3), np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: PoseNet().init(
        k, image, [image, image]))(jax.random.PRNGKey(3)))['params']
    params = perturb(params, np.random.RandomState(3))
    state = types.SimpleNamespace(epoch=0, step=0, params={'pose': params},
                                  batch_stats={}, opt_state=())
    jsave_checkpoint(str(path), train_config('', '', ''), state)
    return str(path), params


def port_yaml(jcfg, path):
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    cfg.save_yaml(path)
    return path


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('train')
    split = make_dataset(str(root / 'data'), n=4, h=H, w=W)
    init = write_init_checkpoint(root / 'init.ckpt')
    jdir, pdir = str(root / 'jax'), str(root / 'port')
    JaxExperiment(train_config(split, jdir, init)).fit()
    yaml_path = port_yaml(train_config(split, pdir, init), str(root / 'port.yaml'))
    exp = train_edges.main([yaml_path], device='cpu')
    return dict(root=root, split=split, init=init, jdir=jdir, pdir=pdir,
                yaml=yaml_path, exp=exp)


@pytest.fixture(scope='module')
def dee_runs(runs):
    """DEE for 2 epochs on the same split and starting weights."""
    root = runs['root']
    jdir, pdir = str(root / 'dee_jax'), str(root / 'dee_port')
    jcfg = lambda d: train_config(runs['split'], d, runs['init'],
                                  model='EdgeEstimationLIDARModel')
    JaxExperiment(jcfg(jdir)).fit()
    exp = train_edges.main([port_yaml(jcfg(pdir), str(root / 'dee.yaml'))], device='cpu')
    return dict(jdir=jdir, pdir=pdir, exp=exp)


@pytest.fixture(scope='module')
def kitti_runs(runs):
    """``SemiSupModel`` with PoseNet for 1 epoch on a 6-frame KITTI tree."""
    root = runs['root']
    tree = str(root / 'kitti')
    split = write_kitti_tree(tree, n_frames=6, h=H, w=W, no_gt=())
    pose_ckpt, pose_params = write_pose_checkpoint(root / 'pose.ckpt')
    jdir, pdir = str(root / 'kitti_jax'), str(root / 'kitti_port')
    jcfg = lambda d: kitti_config(tree, split, d, runs['init'], pose_ckpt)
    jexp = JaxExperiment(jcfg(jdir))
    jexp.initialize_state(next(iter(jexp.train_loader)))
    jexp.state = jexp.state.replace(params=dict(jexp.state.params, pose=pose_params))
    jexp.fit()
    yaml_path = port_yaml(jcfg(pdir), str(root / 'kitti.yaml'))
    exp = train_edges.main([yaml_path], device='cpu')
    return dict(jdir=jdir, pdir=pdir, exp=exp, yaml=yaml_path)


def test_epoch_losses_match_jax(runs):
    got, want = epoch_losses(runs['pdir']), epoch_losses(runs['jdir'])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-2)


def test_checkpoint_names_and_retention_match_jax(runs):
    """``epoch=NN_f1=..._loss=...``, the top-1 retention with save_freq 2:
    the same files are kept on both sides; the port's run also leaves its
    yaml, its code snapshot and the metrics log beside them."""
    got, want = ckpts(runs['pdir']), ckpts(runs['jdir'])
    assert shape_of(got) == shape_of(want)
    assert all(re.fullmatch(r'epoch=0[12]_f1=[0-9.]+_loss=[0-9.]+\.ckpt', n) for n in got)
    assert {'port.yaml', 'code.tar.gz', 'metrics.jsonl'} <= set(os.listdir(runs['pdir']))


def test_checkpoint_holds_the_final_state(runs):
    """The newest checkpoint reloads bit-equal to the trained network, with
    the next-epoch index, the global step, the optimizer and scheduler."""
    state = runs['exp'].state
    assert (state.epoch, state.step) == (2, 4)
    path = os.path.join(runs['pdir'], ckpts(runs['pdir'])[-1])
    ckpt = load_checkpoint(path)
    assert ckpt['epoch'] == 2 and ckpt['global_step'] == 4
    assert ckpt['config']['model']['name'] == 'SemiSupEdgeModel'
    own = state.net.state_dict()
    assert set(ckpt['state_dict']) == {f'model.depth_net.{k}' for k in own}
    for k, v in own.items():
        assert torch.equal(ckpt['state_dict'][f'model.depth_net.{k}'], v), k
    assert ckpt['scheduler']['last_epoch'] == 2
    assert all(s['step'] == 4 for s in ckpt['optimizer']['state'].values())


def test_resume_restores_epoch_step_and_rate(runs, tmp_path):
    """A yaml whose checkpoint directory holds checkpoints resumes from the
    newest: epoch 2, step 4, the rate decayed twice; one more epoch runs
    2 more steps.  (On a copy of the run's directory.)"""
    import shutil
    ckpt_dir = str(tmp_path / 'resumed')
    shutil.copytree(runs['pdir'], ckpt_dir)
    cfg, _ = config.parse_train_file(runs['yaml'])
    cfg.checkpoint.filepath = ckpt_dir
    yaml_path = str(tmp_path / 'resume.yaml')
    cfg.save_yaml(yaml_path)
    cfg, resume = config.parse_train_file(yaml_path)
    assert resume == os.path.join(ckpt_dir, ckpts(ckpt_dir)[-1])
    cfg.arch.max_epochs = 3
    exp = Experiment(cfg, resume_ckpt=resume, device='cpu')
    state = exp.initialize_state()
    assert (state.epoch, state.step) == (2, 4)
    assert state.optimizer.param_groups[0]['lr'] == pytest.approx(LR * 0.25)
    exp.fit()
    assert (exp.state.epoch, exp.state.step) == (3, 6)
    assert exp.state.optimizer.param_groups[0]['lr'] == pytest.approx(LR * 0.125)


def test_saved_state_dict_gives_the_same_jax_forward(runs):
    """The port's checkpoint maps into JAX params through the JAX package's
    ``port_packnet_san`` and gives the JAX eval forward the port's own eval
    forward gives (rtol 1e-3, the eval parity's tolerance)."""
    ckpt = load_checkpoint(os.path.join(runs['pdir'], ckpts(runs['pdir'])[-1]))
    jtask = jtasks.build_task(train_config('', '', ''))
    rng = np.random.RandomState(7)
    rgb = rng.rand(2, H, W, 3).astype(np.float32)
    lidar = (rng.rand(2, H, W, 1) * 50).astype(np.float32)
    lidar[rng.rand(2, H, W, 1) < 0.95] = 0.0
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init)(
        jax.random.PRNGKey(1), {'rgb': rgb, 'input_depth': lidar}))['depth']
    zero = jax.tree_util.tree_map(np.zeros_like, variables)
    params, stats, _ = port_packnet_san(ckpt['state_dict'], zero['params'],
                                        zero['batch_stats'])
    want = jax.jit(lambda v, r, d: jtask.depth_net.apply(v, r, d, train=False))(
        {'params': params, 'batch_stats': stats}, rgb, lidar)['inv_depths']
    net = runs['exp'].state.net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(rgb), torch.from_numpy(lidar))['inv_depths']
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4,
                                   err_msg=f'scale {s}')


def test_train_without_cuda_raises(runs, monkeypatch):
    """``device=None`` means the card: without one the CLI raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_edges.main([runs['yaml']])


def assert_fp32_checkpoint(ckpt_dir, state):
    """The newest checkpoint holds fp32 tensors (``num_batches_tracked``
    int64) equal to the trained network, and fp32 Adam moments."""
    ckpt = load_checkpoint(os.path.join(ckpt_dir, ckpts(ckpt_dir)[-1]))
    for k, v in ckpt['state_dict'].items():
        assert v.dtype == (torch.int64 if k.endswith('num_batches_tracked')
                           else torch.float32), k
    for k, v in state.net.state_dict().items():
        assert torch.equal(ckpt['state_dict'][f'model.depth_net.{k}'], v), k
    for s in ckpt['optimizer']['state'].values():
        assert s['exp_avg'].dtype == s['exp_avg_sq'].dtype == torch.float32


@pytest.mark.parametrize('key,value', [
    ('arch.precision', 'bfloat16'),
    ('model.depth_net.remat', True),
    ('model.depth_net.remat', 'conv'),
])
def test_precision_and_remat_options_train(runs, tmp_path, key, value):
    """bf16 and both recomputation modes train one epoch through the CLI
    and write a checkpoint of fp32 tensors."""
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(train_config(runs['split'], str(tmp_path / 'ck'),
                                          runs['init']).to_dict())
    cfg.merge_from_list([key, value, 'arch.max_epochs', 1])
    path = str(tmp_path / 'option.yaml')
    cfg.save_yaml(path)
    exp = train_edges.main([path], device='cpu')
    assert exp.state.step == 2 and np.isfinite(epoch_losses(str(tmp_path / 'ck'))).all()
    assert_fp32_checkpoint(str(tmp_path / 'ck'), exp.state)


def test_shipped_yaml_trains_in_bf16_and_resumes_in_fp32(runs, tmp_path):
    """``configs/train_packnet_san_kitti_with_edges.yaml`` as written (bf16,
    dropout 0.5, flip 0.5, batch 3), its data paths, sizes (64x96, channels
    (16,)*6), epochs and checkpoint folder replaced: one epoch in bf16, then
    its checkpoint resumes in fp32 for a second."""
    cfg = config.get_cfg_defaults()
    cfg.merge_from_file('configs/train_packnet_san_kitti_with_edges.yaml')
    assert cfg.arch.precision == 'bfloat16' and cfg.model.depth_net.dropout == 0.5
    for mode in ('train', 'validation'):
        cfg.datasets[mode].path, cfg.datasets[mode].split = [''], [runs['split']]
    cfg.datasets.augmentation.image_shape = (H, W)
    cfg.model.depth_net.channels = CHANNELS
    cfg.arch.max_epochs = 1
    cfg.checkpoint.filepath = str(tmp_path / 'ck')
    path = str(tmp_path / 'shipped.yaml')
    cfg.save_yaml(path)
    exp = train_edges.main([path], device='cpu')
    assert exp.task.compute_dtype == torch.bfloat16 and exp.state.step == 1
    assert_fp32_checkpoint(cfg.checkpoint.filepath, exp.state)
    cfg.arch.precision, cfg.arch.max_epochs = 'float32', 2
    cfg.save_yaml(path)
    exp = train_edges.main([path], device='cpu')
    assert exp.task.compute_dtype == torch.float32
    assert (exp.state.epoch, exp.state.step) == (2, 2)
    assert_fp32_checkpoint(cfg.checkpoint.filepath, exp.state)


@pytest.mark.parametrize('key,value,item', [
    ('arch.dp_devices', 2, 'torchrun --nproc_per_node 2'),
])
def test_unported_options_raise_before_work(runs, tmp_path, key, value, item):
    """An option this process cannot carry raises before any training
    step, naming what to do (``arch.dp_devices`` 2 without a process group
    of 2: launch under torchrun); the checkpoint directory gets no
    checkpoint."""
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(train_config(runs['split'], str(tmp_path / 'ck'),
                                          runs['init']).to_dict())
    cfg.merge_from_list([key, value])
    path = str(tmp_path / 'bad.yaml')
    cfg.save_yaml(path)
    with pytest.raises(ValueError, match=item):
        train_edges.main([path], device='cpu')
    assert not (tmp_path / 'ck').exists() or not ckpts(str(tmp_path / 'ck'))


def test_photometric_without_pose_net_raises_before_work(runs, tmp_path):
    """Below ``supervised_loss_weight`` 1 the task runs the photometric
    loss, which needs a pose network: without ``model.pose_net.name`` the
    CLI raises before any training step."""
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(train_config(runs['split'], str(tmp_path / 'ck'),
                                          runs['init']).to_dict())
    cfg.model.loss.supervised_loss_weight = 0.9
    path = str(tmp_path / 'nopose.yaml')
    cfg.save_yaml(path)
    with pytest.raises(ValueError, match='model.pose_net.name'):
        train_edges.main([path], device='cpu')
    assert not (tmp_path / 'ck').exists() or not ckpts(str(tmp_path / 'ck'))


def test_dee_epoch_losses_match_jax(dee_runs):
    got, want = epoch_losses(dee_runs['pdir']), epoch_losses(dee_runs['jdir'])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert shape_of(ckpts(dee_runs['pdir'])) == shape_of(ckpts(dee_runs['jdir']))
    assert dee_runs['exp'].state.pose_net is None


def train_metrics(ckpt_dir):
    with open(os.path.join(ckpt_dir, 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    return {k: v for r in rows for k, v in r.items() if k.startswith('train/')}


def test_kitti_selfsup_epoch_matches_jax(kitti_runs):
    """The epoch's mean loss, photometric, smoothness and supervised terms
    (rtol 1e-2) and its checkpoint names."""
    got, want = train_metrics(kitti_runs['pdir']), train_metrics(kitti_runs['jdir'])
    keys = {'train/loss', 'train/photometric_loss', 'train/smoothness_loss',
            'train/supervised_loss', 'train/grad_norm'}
    assert keys <= set(got) and keys <= set(want)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, err_msg=k)
    assert shape_of(ckpts(kitti_runs['pdir'])) == shape_of(ckpts(kitti_runs['jdir']))
    assert kitti_runs['exp'].state.step == 2


def test_kitti_checkpoint_holds_and_restores_the_pose_net(kitti_runs):
    """The checkpoint holds ``model.pose_net.`` keys beside
    ``model.depth_net.``, bit-equal to the trained networks, and a resume
    restores both networks and the pose group's Adam state."""
    state = kitti_runs['exp'].state
    path = os.path.join(kitti_runs['pdir'], ckpts(kitti_runs['pdir'])[-1])
    ckpt = load_checkpoint(path)
    pose = {k: v for k, v in ckpt['state_dict'].items() if k.startswith('model.pose_net.')}
    assert set(pose) == {f'model.pose_net.{k}' for k in state.pose_net.state_dict()}
    for k, v in state.pose_net.state_dict().items():
        assert torch.equal(pose[f'model.pose_net.{k}'], v), k
    assert len(ckpt['optimizer']['param_groups']) == 2
    cfg, _ = config.parse_train_file(kitti_runs['yaml'])
    exp = Experiment(cfg, load_datasets=False, device='cpu')
    fresh = create_train_state(cfg, exp.task.depth_net, pose_net=exp.task.pose_net)
    restored = restore_train_state(fresh, ckpt)
    for a, b in zip(state.parameters(), restored.parameters()):
        assert torch.equal(a, b)
    assert restored.optimizer.param_groups[1]['lr'] == state.optimizer.param_groups[1]['lr']
    assert len(restored.optimizer.state) == len(state.optimizer.state)
