"""Config system: counterpart of ``mindtheedge_tpu/config/__init__.py:15-41,
81-102`` (``prep_dataset``, ``prepare_config``, ``parse_test_file``).

Reference behaviour: ``packnet_code/packnet_sfm/utils/config.py:16-47,
354-486``.  ``parse_train_file`` waits for the training slice (ROADMAP
Slice C).
"""

from datetime import datetime

from mindtheedge_tpu_torch.config.defaults import get_cfg_defaults
from mindtheedge_tpu_torch.config.node import ConfigNode


def prep_dataset(cfg):
    """Broadcast per-dataset list entries to the number of datasets.

    Reference: ``utils/config.py:16-47`` (``prep_dataset``).
    """
    n = len(cfg.path)
    for key in ['dataset', 'split', 'depth_type', 'input_depth_type', 'cameras', 'repeat']:
        if key in cfg:
            val = cfg[key]
            if not isinstance(val, (list, tuple)):
                val = [val]
            if len(val) == 0:
                val = [''] if key != 'cameras' else [[]]
            if len(val) < n:
                val = list(val) + [val[-1]] * (n - len(val))
            cfg[key] = list(val)[:max(n, len(val))]
    return cfg


def prepare_config(cfg):
    """Post-process a merged config (dataset broadcasting, run name)."""
    for mode in ['train', 'validation', 'test']:
        prep_dataset(cfg.datasets[mode])
    if not cfg.name:
        cfg.name = datetime.now().strftime('%Y-%m-%d_%Hh%Mm%Ss')
    cfg.prepared = True
    return cfg


def parse_test_file(ckpt_path, yaml_path=None, overrides=None):
    """Parse a test checkpoint (+ optional yaml override).

    The checkpoint's embedded config is recovered and merged under the yaml,
    mirroring reference ``utils/config.py:354-486``.  Both checkpoint
    formats of ``training/checkpoint.load_checkpoint`` are read.
    Returns ``(config, checkpoint)``.
    """
    if not ckpt_path.endswith('.ckpt'):
        raise ValueError(f'Test file must be a .ckpt checkpoint: {ckpt_path}')
    from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint
    ckpt = load_checkpoint(ckpt_path)

    cfg = get_cfg_defaults()
    if 'config' in ckpt and ckpt['config']:
        cfg.merge_from_other_cfg(ckpt['config'])
    if yaml_path is not None:
        cfg.merge_from_file(yaml_path)
        cfg.config = yaml_path
    if overrides:
        cfg.merge_from_list(overrides)
    cfg.checkpoint.filepath = ckpt_path
    cfg = prepare_config(cfg)
    return cfg, ckpt


__all__ = ['ConfigNode', 'get_cfg_defaults', 'prepare_config',
           'parse_test_file', 'prep_dataset']
