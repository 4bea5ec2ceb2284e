"""Checkpoint loading: counterpart of ``mindtheedge_tpu/training/checkpoint.py:
47-77`` (``load_checkpoint``, ``restore_params``) for the depth network.

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

``restore_depth_net(model, ckpt)`` loads every entry whose name and shape
match the port's model and prints ``Restored n/total params`` as
``restore_params`` does.
"""

import pickle
import zipfile

import torch

from mindtheedge_tpu_torch.utils.weights import state_dict_from_jax

_BUILTINS = frozenset((
    'bool', 'bytearray', 'bytes', 'complex', 'dict', 'float', 'frozenset',
    'int', 'list', 'range', 'set', 'slice', 'str', 'tuple'))
_NUMPY = frozenset((      # numpy's own reconstructors, under numpy 1 and 2
    ('numpy', 'dtype'), ('numpy', 'ndarray'),
    ('numpy.core.multiarray', '_reconstruct'), ('numpy.core.multiarray', 'scalar'),
    ('numpy._core.multiarray', '_reconstruct'), ('numpy._core.multiarray', 'scalar'),
    ('numpy.core.numeric', '_frombuffer'), ('numpy._core.numeric', '_frombuffer')))
_PREFIXES = ('model.depth_net.', 'depth_net.', 'module.', 'model.')


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


def depth_state_dict(ckpt):
    """The depth network's weights in a checkpoint of either format, under
    the port's (reference PackNetSAN01) names."""
    sd = ckpt['state_dict']
    if isinstance(sd.get('depth'), dict):       # (a) flax trees
        stats = (ckpt.get('batch_stats') or {}).get('depth')
        return state_dict_from_jax(sd['depth'], stats)
    return {k: torch.as_tensor(v) for k, v in strip_prefix(sd).items()}


def restore_depth_net(model, ckpt):
    """Load the entries of ``ckpt`` whose name and shape match ``model``
    and print how many of its parameters they cover."""
    own = model.state_dict()
    loaded = {k: v for k, v in depth_state_dict(ckpt).items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
    model.load_state_dict(loaded, strict=False)
    names = [name for name, _ in model.named_parameters()]
    n = sum(name in loaded for name in names)
    print(f'Restored {n}/{len(names)} params')
