"""Checkpoint loading in the port (mindtheedge_tpu_torch/training/checkpoint.py)
against the JAX package's checkpoints and restore.

* format (a), the JAX package's pickle written by its ``save_checkpoint``
  with an Adam state, loads without JAX and restores every parameter;
* format (b), a torch ``.ckpt`` with reference-prefixed keys and a plain-dict
  config, gives the same outputs, bit for bit, as the same weights in
  format (a);
* a pickled class that is neither builtin, numpy nor an optax state raises,
  naming the class;
* ``parse_test_file`` recovers the checkpoint's config as the JAX package's
  does.
"""

import argparse
import pickle

import numpy as np
import pytest
import torch
import flax.core

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu.training.checkpoint import restore_params
from mindtheedge_tpu_torch import config
from mindtheedge_tpu_torch.models import tasks
from mindtheedge_tpu_torch.training import checkpoint
from tests.test_torch_tasks import inputs, write_jax_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def jax_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp('ckpt') / 'dee.ckpt'
    _, variables, jcfg = write_jax_checkpoint(path, 'EdgeEstimationLIDARModel')
    return path, variables, jcfg


def port_config(jcfg):
    cfg = config.get_cfg_defaults()
    cfg.merge_from_other_cfg(jcfg.to_dict())
    return cfg


def test_jax_format_loads_and_restores_every_param(jax_ckpt, capsys):
    path, variables, jcfg = jax_ckpt
    ckpt = checkpoint.load_checkpoint(str(path))
    assert ckpt['epoch'] == 3 and ckpt['global_step'] == 30
    assert isinstance(ckpt['optimizer'], tuple)          # optax state, inert
    _, n_jax, total_jax = restore_params(ckpt['state_dict'],
                                         {'depth': variables['depth']['params']})
    task = tasks.build_task(port_config(jcfg), device='cpu', ckpt=ckpt)
    assert capsys.readouterr().out.strip() == f'Restored {n_jax}/{total_jax} params'
    assert n_jax == total_jax
    sd = task.depth_net.state_dict()
    k = 'mconvs.mconvs.0.layer_final.0.bn.running_var'
    np.testing.assert_array_equal(
        sd[k].numpy(),
        variables['depth']['batch_stats']['mconvs']['mconv0']['final_bn']['var'])


def test_torch_format_prefixed_matches_jax_format(jax_ckpt, tmp_path, capsys):
    path, _, jcfg = jax_ckpt
    cfg = port_config(jcfg)
    from_jax = tasks.build_task(cfg, device='cpu',
                                ckpt=checkpoint.load_checkpoint(str(path)))
    sd = from_jax.depth_net.state_dict()
    prefixes = ('model.depth_net.', 'depth_net.', 'module.', 'model.')
    ref = {prefixes[i % 4] + k: v.clone() for i, (k, v) in enumerate(sd.items())}
    ref['model.pose_net.decoder.weight'] = torch.zeros(3)   # not the depth net's
    torch_path = tmp_path / 'ref.ckpt'
    torch.save({'config': jcfg.to_dict(), 'state_dict': ref, 'epoch': 1},
               torch_path)
    capsys.readouterr()
    from_torch = tasks.build_task(cfg, device='cpu',
                                  ckpt=checkpoint.load_checkpoint(str(torch_path)))
    n_params = len(list(from_torch.depth_net.parameters()))
    assert capsys.readouterr().out.strip() == f'Restored {n_params}/{n_params} params'
    rgb, lidar = (torch.from_numpy(a) for a in inputs())
    batch = {'rgb': rgb, 'input_depth': lidar}
    for a, b in zip(from_jax.infer(batch)['inv_depths'],
                    from_torch.infer(batch)['inv_depths']):
        assert torch.equal(a, b)


def test_unknown_pickled_class_raises(tmp_path):
    for obj, name in ((flax.core.FrozenDict({'a': np.ones(2)}),
                       'flax.core.frozen_dict.FrozenDict'),
                      (argparse.Namespace(a=1), 'argparse.Namespace')):
        path = tmp_path / 'bad.ckpt'
        with open(path, 'wb') as f:
            pickle.dump({'state_dict': {'depth': {'x': obj}}}, f)
        with pytest.raises(pickle.UnpicklingError, match=name):
            checkpoint.load_checkpoint(str(path))


def test_strip_prefix_matches_jax_porter():
    from mindtheedge_tpu.utils.torch_port import _strip_prefix
    keys = ['model.depth_net.encoder.conv1.weight', 'depth_net.weight',
            'module.model.bias', 'model.module.x', 'decoder.iconv1.y',
            'module.depth_net.z']
    sd = {k: i for i, k in enumerate(keys)}
    assert checkpoint.strip_prefix(sd) == _strip_prefix(sd)


def test_parse_test_file_recovers_config_like_jax(jax_ckpt, tmp_path):
    path = jax_ckpt[0]
    yaml_path = tmp_path / 'override.yaml'
    yaml_path.write_text("datasets:\n  augmentation:\n    image_shape: (64, 96)\n")
    got, ckpt = config.parse_test_file(str(path), str(yaml_path))
    want, _ = jconfig.parse_test_file(str(path), str(yaml_path))
    assert got.to_dict() == want.to_dict()
    assert got.model.depth_net.channels == (16,) * 6
    assert got.datasets.augmentation.image_shape == (64, 96)
    assert set(ckpt['state_dict']) == {'depth'}
    with pytest.raises(ValueError, match='.ckpt'):
        config.parse_test_file(str(yaml_path))
