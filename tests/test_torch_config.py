"""The port's config tree (mindtheedge_tpu_torch/config) against the JAX
package's: every shipped ``configs/*.yaml`` merges into the port's defaults
and gives the same tree, exactly."""

from pathlib import Path

import pytest

from mindtheedge_tpu import config as jconfig
from mindtheedge_tpu_torch import config

CONFIGS = sorted((Path(__file__).resolve().parents[1] / 'configs').glob('*.yaml'))


def test_defaults_match_jax():
    assert config.get_cfg_defaults().to_dict() == jconfig.get_cfg_defaults().to_dict()


@pytest.mark.parametrize('path', CONFIGS, ids=[p.stem for p in CONFIGS])
def test_shipped_config_merges_like_jax(path):
    cfg = config.get_cfg_defaults()
    cfg.merge_from_file(str(path))
    want = jconfig.get_cfg_defaults()
    want.merge_from_file(str(path))
    cfg.name = want.name = 'run'        # prepare_config names unnamed runs by time
    got, want = (config.prepare_config(cfg).to_dict(),
                 jconfig.prepare_config(want).to_dict())
    assert got == want
    assert isinstance(cfg.datasets.augmentation.image_shape, tuple)


def test_merge_from_list_and_type_checks():
    cfg = config.get_cfg_defaults()
    cfg.merge_from_list(['datasets.augmentation.image_shape', '(64, 96)',
                         'arch.seed', '7'])
    assert cfg.datasets.augmentation.image_shape == (64, 96)
    assert cfg.arch.seed == 7
    with pytest.raises(ValueError, match='Type mismatch'):
        cfg.merge_from_other_cfg({'arch': {'seed': 'not a number'}})
    with pytest.raises(ValueError, match='even length'):
        cfg.merge_from_list(['arch.seed'])
