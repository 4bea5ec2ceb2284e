"""The port's small host helpers against the JAX package's: the LiDAR beam
sampler (``ops/lidar_sim.lidar_sample``, equal to JAX's on seeded depth
maps, with and without pitch), ``evaluation/chamfer.edge_precision_recall``
(equal), ``data/datasets.register_dataset``,
``utils/profiling.trace`` (writes a Chrome trace; where the profiler
cannot start it says so and runs the block) and ``device_memory_stats``
(``{}`` without a CUDA device), and ``training/trainer.HorovodTrainer``.
"""

import json
import os

import numpy as np
import pytest
import torch

from mindtheedge_tpu.data import datasets as jdatasets
from mindtheedge_tpu.evaluation import chamfer as jchamfer
from mindtheedge_tpu.ops import lidar_sim as jlidar_sim
from mindtheedge_tpu_torch.data import datasets
from mindtheedge_tpu_torch.evaluation import chamfer
from mindtheedge_tpu_torch.ops import lidar_sim
from mindtheedge_tpu_torch.training import trainer
from mindtheedge_tpu_torch.utils import profiling

torch.set_num_threads(1)


def depth_map(seed, h=60, w=80):
    """A seeded dense depth map in metres: a slanted ground and boxes."""
    rng = np.random.RandomState(seed)
    depth = np.tile(np.linspace(60.0, 5.0, h)[:, None], (1, w))
    for _ in range(3):
        y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
        depth[y:y + rng.randint(5, h // 2), x:x + rng.randint(5, w // 2)] = rng.uniform(3, 40)
    return depth + rng.rand(h, w)


@pytest.mark.parametrize('pitch', [0.0, 0.05], ids=['level', 'pitched'])
@pytest.mark.parametrize('seed', [0, 1])
def test_lidar_sample_equals_jax(pitch, seed):
    depth = depth_map(seed)
    kwargs = dict(f=60.0, u0=40.0, v0=30.0, lidar_pitch=pitch, lidar_beams=16,
                  lidar_ver_angle=20.0, lidar_hor_res=0.5, max_depth=50.0)
    got = lidar_sim.lidar_sample(depth, **kwargs)
    want = jlidar_sim.lidar_sample(depth, **kwargs)
    assert got.dtype == want.dtype and got.shape == depth.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < depth.size and got.max() <= 50.0


def test_edge_precision_recall_equals_jax():
    rng = np.random.RandomState(0)
    gt = np.zeros((40, 50))
    gt[10, 5:45] = gt[5:35, 30] = 255.0
    pred = np.roll(gt, (2, 1), (0, 1)) * (rng.rand(40, 50) > 0.2)
    pred[rng.rand(40, 50) > 0.97] = 255.0
    got = chamfer.edge_precision_recall(pred, gt, thresh_px=3)
    assert got == jchamfer.edge_precision_recall(pred, gt, thresh_px=3)
    assert 0.0 < got[0] < 1.0 and 0.0 < got[1] <= 1.0 and 0.0 < got[2] < 1.0


def test_register_dataset_as_jax():
    class Dummy:
        pass
    try:
        datasets.register_dataset('Dummy', Dummy)
        jdatasets.register_dataset('Dummy', Dummy)
        assert datasets.DATASET_REGISTRY['Dummy'] is jdatasets.DATASET_REGISTRY['Dummy'] is Dummy
    finally:
        datasets.DATASET_REGISTRY.pop('Dummy', None)
        jdatasets.DATASET_REGISTRY.pop('Dummy', None)


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).add_(1).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith('.json')
    with open(tmp_path / files[0]) as f:
        assert json.load(f)['traceEvents']
    assert f'profiler trace written to {tmp_path / files[0]}' in capsys.readouterr().out
    with profiling.trace(str(tmp_path / 'off'), enabled=False):
        pass
    assert not (tmp_path / 'off').exists()


def test_trace_degrades_and_runs_the_block(tmp_path, capsys, monkeypatch):
    import torch.profiler

    def refuse(**kwargs):
        raise RuntimeError('no profiler here')
    monkeypatch.setattr(torch.profiler, 'profile', refuse)
    ran = []
    with profiling.trace(str(tmp_path / 'trace')):
        ran.append(True)
    assert ran == [True] and not (tmp_path / 'trace').exists()
    assert 'profiler trace unavailable: RuntimeError: no profiler here' in capsys.readouterr().out


def test_device_memory_stats_without_cuda():
    assert not torch.cuda.is_available()
    assert profiling.device_memory_stats() == {}


def test_horovod_trainer_is_the_common_trainer():
    assert trainer.HorovodTrainer is trainer.CommonTrainer
