"""Checkpoints: counterpart of ``mindtheedge_tpu/training/checkpoint.py``
(reference ``models/model_checkpoint.py``).

``load_checkpoint(path)`` reads two formats:

* **(a) the JAX package's single-file pickle** (``checkpoint.py:27-49``): a
  dict whose ``state_dict['depth']`` and ``batch_stats['depth']`` are flax
  parameter trees of numpy arrays.  It is read by an unpickler that admits
  only builtins and numpy, plus optax's optimizer-state NamedTuples, which
  become plain tuples here (the port never reads the optimizer state); any
  other class raises, naming it, so loading never imports JAX or flax.
* **(b) a reference torch ``.ckpt``** (a ``torch.save`` zip archive), read
  with ``torch.load(weights_only=True)``.  Its ``state_dict`` keys carry
  ``model.depth_net.`` / ``depth_net.`` / ``module.`` / ``model.`` prefixes
  (``utils/torch_port.py:45-53``).

``restore_depth_net(model, ckpt)`` and ``restore_pose_net(model, ckpt)``
load every entry of that network whose name and shape match the port's
model and print ``Restored n/total params`` as ``restore_params`` does.
A pose network's entries are ``state_dict['pose']`` in format (a) (a
``PoseNet`` or ``PoseResNet`` tree) and the ``model.pose_net.`` /
``pose_net.`` keys in format (b).

The save side (``checkpoint.py:27-45, 109-210``): ``save_checkpoint``
writes format (b), a ``torch.save`` file whose ``state_dict`` holds the
reference names under ``model.depth_net.`` (and the pose network's under
``model.pose_net.``), beside ``optimizer``,
``scheduler``, ``epoch`` (the index of the epoch to run next),
``global_step``, ``config`` and ``metrics``.  ``ModelCheckpoint`` names the
files ``epoch=NN[_f1=...][_<monitor>=...].ckpt`` with the ``b.ckpt``
collision suffix, keeps the top k and snapshots the port's code beside
them.  ``restore_train_state`` resumes from such a file.
"""

import os
import pickle
import tarfile
import zipfile

import numpy as np

import torch

from mindtheedge_tpu_torch.utils.weights import (
    pose_state_dict_from_jax, resnet_state_dict_from_jax, state_dict_from_jax)

_BUILTINS = frozenset((
    'bool', 'bytearray', 'bytes', 'complex', 'dict', 'float', 'frozenset',
    'int', 'list', 'range', 'set', 'slice', 'str', 'tuple'))
_NUMPY = frozenset((      # numpy's own reconstructors, under numpy 1 and 2
    ('numpy', 'dtype'), ('numpy', 'ndarray'),
    ('numpy.core.multiarray', '_reconstruct'), ('numpy.core.multiarray', 'scalar'),
    ('numpy._core.multiarray', '_reconstruct'), ('numpy._core.multiarray', 'scalar'),
    ('numpy.core.numeric', '_frombuffer'), ('numpy._core.numeric', '_frombuffer')))
_PREFIXES = ('model.depth_net.', 'depth_net.', 'module.', 'model.')
_POSE_PREFIXES = ('model.pose_net.', 'pose_net.')


class _OptimizerState(tuple):
    """Stand-in for an optax state NamedTuple: its fields as a plain tuple."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    """Admits builtins, numpy and optax states; raises on any other class."""

    def find_class(self, module, name):
        if module == 'builtins' and name in _BUILTINS \
                or (module, name) in _NUMPY:
            return super().find_class(module, name)
        if module.startswith('optax.') and name.endswith('State'):
            return type(name, (_OptimizerState,), {'__module__': module})
        raise pickle.UnpicklingError(
            f'checkpoint holds {module}.{name}, which the port does not load '
            '(it admits builtins, numpy arrays and optax states only)')


def load_checkpoint(path):
    """Read a checkpoint of either format -> dict."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location='cpu', weights_only=True)
    with open(path, 'rb') as f:
        return _Unpickler(f).load()


def strip_prefix(state_dict):
    """Remove 'model.depth_net.' / 'depth_net.' / 'module.' / 'model.'
    prefixes, in that order (``utils/torch_port.py:45-53``)."""
    out = {}
    for key, val in state_dict.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
        out[key] = val
    return out


def split_state_dict(state_dict):
    """A torch ``state_dict`` -> (the depth network's entries, the pose
    network's with its ``model.pose_net.`` / ``pose_net.`` prefix removed)."""
    depth, pose = {}, {}
    for key, val in state_dict.items():
        prefix = next((p for p in _POSE_PREFIXES if key.startswith(p)), None)
        if prefix is None:
            depth[key] = val
        else:
            pose[key[len(prefix):]] = val
    return depth, pose


def _is_flax(ckpt):
    sd = ckpt['state_dict']
    return isinstance(sd.get('depth'), dict) or isinstance(sd.get('pose'), dict)


def depth_state_dict(ckpt):
    """The depth network's weights in a checkpoint of either format, under
    the port's (reference PackNetSAN01 or monodepth2) names."""
    if _is_flax(ckpt):                          # (a) flax trees
        tree = ckpt['state_dict']['depth']
        stats = (ckpt.get('batch_stats') or {}).get('depth')
        if 'mconvs' in tree:
            return state_dict_from_jax(tree, stats)
        return resnet_state_dict_from_jax(tree, stats)
    depth, _ = split_state_dict(ckpt['state_dict'])
    return {k: torch.as_tensor(v) for k, v in strip_prefix(depth).items()}


def pose_state_dict(ckpt):
    """The pose network's weights in a checkpoint of either format ({}
    where it holds none)."""
    if _is_flax(ckpt):
        tree = ckpt['state_dict'].get('pose')
        if tree is None:
            return {}
        return pose_state_dict_from_jax(tree, (ckpt.get('batch_stats') or {}).get('pose'))
    _, pose = split_state_dict(ckpt['state_dict'])
    return {k: torch.as_tensor(v) for k, v in pose.items()}


def _restore(model, entries, what):
    own = model.state_dict()
    loaded = {k: v for k, v in entries.items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(loaded, strict=False)
    names = [name for name, _ in model.named_parameters()]
    n = sum(name in loaded for name in names)
    print(f'Restored {n}/{len(names)} {what}params')


def restore_depth_net(model, ckpt):
    """Load the depth entries of ``ckpt`` whose name and shape match
    ``model`` and print how many of its parameters they cover."""
    _restore(model, depth_state_dict(ckpt), '')


def restore_pose_net(model, ckpt):
    """As :func:`restore_depth_net`, for the pose network."""
    _restore(model, pose_state_dict(ckpt), 'pose ')


def save_checkpoint(path, config, state, metrics=None):
    """Write ``state`` (a ``training.state.TrainState``) to ``path``
    atomically, through a temporary file."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    payload = {
        'config': config.to_dict() if hasattr(config, 'to_dict') else dict(config),
        'epoch': int(state.epoch),
        'global_step': int(state.step),
        'state_dict': {f'model.{net}.{k}': v.detach().cpu()
                       for net, module in (('depth_net', state.net),
                                           ('pose_net', state.pose_net))
                       if module is not None
                       for k, v in module.state_dict().items()},
        'optimizer': state.optimizer.state_dict(),
        'scheduler': state.scheduler.state_dict(),
        'metrics': {k: float(v) for k, v in (metrics or {}).items()},
        'format_version': 1,
    }
    tmp = path + '.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(state, ckpt):
    """Resume ``state`` from a checkpoint that ``save_checkpoint`` wrote:
    the network (strictly), the optimizer's moments and step counts, the
    scheduler's position, ``epoch`` and ``step`` (``experiment.py:150-178``);
    the pose network too where the state has one."""
    state.net.load_state_dict(depth_state_dict(ckpt))
    if state.pose_net is not None:
        state.pose_net.load_state_dict(pose_state_dict(ckpt))
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.scheduler.load_state_dict(ckpt['scheduler'])
    state.epoch = int(ckpt['epoch'])
    state.step = int(ckpt['global_step'])
    return state


class ModelCheckpoint:
    """Top-k checkpoint manager (``checkpoint.py:109-210``, reference
    ``model_checkpoint.py``); this process is the one writer.  The S3 sync
    (``s3_path``) waits for ROADMAP Queue 1 item 25."""

    def __init__(self, filepath, monitor='loss', save_top_k=5, mode='auto',
                 save_freq=5, s3_path='', yaml_path=''):
        if s3_path:
            raise NotImplementedError(
                f'checkpoint.s3_path {s3_path!r}: the S3 sync waits for '
                'ROADMAP Queue 1 item 25')
        self.dirpath = filepath
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.save_freq = save_freq
        if mode == 'auto':
            # auto min/max by metric name (model_checkpoint.py:44-55)
            mode = 'max' if any(k in monitor for k in
                                ('acc', 'a1', 'a2', 'a3', 'f1', 'precision',
                                 'recall', 'auc')) else 'min'
        self.mode = mode
        self.best = []   # (metric, path, epoch)
        os.makedirs(self.dirpath or '.', exist_ok=True)
        # the run's yaml beside the checkpoints (model_checkpoint.py:62-64)
        if yaml_path and os.path.isfile(yaml_path):
            import shutil
            shutil.copy(yaml_path,
                        os.path.join(self.dirpath, os.path.basename(yaml_path)))
        self._snapshot_code()

    def _snapshot_code(self):
        """The port's code, tarred next to the checkpoints
        (model_checkpoint.py:13-22)."""
        package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with tarfile.open(os.path.join(self.dirpath, 'code.tar.gz'), 'w:gz') as tar:
            tar.add(package, arcname=os.path.basename(package),
                    filter=lambda t: None if '__pycache__' in t.name else t)

    def _filename(self, epoch, metrics):
        parts = [f'epoch={epoch:02d}']
        if metrics:
            prec = [v for k, v in metrics.items() if 'precision' in k]
            rec = [v for k, v in metrics.items() if 'recall' in k]
            if prec and rec:
                # edge-F1 in filenames (model_checkpoint.py:125-149)
                p, r = float(np.mean(prec)), float(np.mean(rec))
                f1 = 2 * p * r / max(p + r, 1e-12)
                parts.append(f'f1={f1:.4f}')
            if self.monitor in metrics:
                parts.append(f'{self.monitor.replace("/", "-")}='
                             f'{float(metrics[self.monitor]):.4f}')
        path = os.path.join(self.dirpath, '_'.join(parts) + '.ckpt')
        while os.path.exists(path):   # collision-avoidance (ref :173-175)
            path = path[:-5] + 'b.ckpt'
        return path

    def check_and_save(self, config, state, metrics):
        epoch = int(state.epoch)
        path = self._filename(epoch, metrics)
        save_checkpoint(path, config, state, metrics)
        value = float(metrics.get(self.monitor, np.nan)) if metrics else np.nan
        self.best.append((value, path, epoch))
        if self.save_top_k and self.save_top_k > 0 and not np.isnan(value):
            ranked = sorted((b for b in self.best if not np.isnan(b[0])),
                            key=lambda t: t[0], reverse=self.mode == 'max')
            for _, stale, stale_epoch in ranked[self.save_top_k:]:
                # retention keyed on the STALE checkpoint's own epoch
                # (model_checkpoint.py:184-191), never the current one
                if os.path.exists(stale) and stale != path \
                        and stale_epoch % max(self.save_freq, 1) != 0:
                    os.remove(stale)
                    self.best = [b for b in self.best if b[1] != stale]
        return path
