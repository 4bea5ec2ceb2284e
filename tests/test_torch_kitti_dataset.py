"""The port's KITTI dataset (mindtheedge_tpu_torch/data/kitti_dataset.py)
against the JAX package's on a synthetic KITTI raw tree
(``tests/test_torch_train_cuda.write_kitti_tree``, the layout of
tests/test_kitti_dataset.py:33-71):
the split filtered by depth availability, context frames at strides 1 and
2, samples (images, per-drive intrinsics, ground truth and LiDAR depth,
oxts poses and the contexts' relative poses) equal to JAX's, raw and
through the train transforms; and the dataset registry.
"""

import numpy as np
import pytest

from mindtheedge_tpu.data.kitti_dataset import KITTIDataset as JaxKITTIDataset
from mindtheedge_tpu.data.transforms import get_transforms as jget_transforms
from mindtheedge_tpu_torch.data.datasets import DATASET_REGISTRY
from mindtheedge_tpu_torch.data.kitti_dataset import KITTIDataset
from mindtheedge_tpu_torch.data.transforms import get_transforms
from tests.test_torch_train_cuda import write_kitti_tree

N_FRAMES, H, W = 7, 16, 32


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('kitti')
    return str(root), write_kitti_tree(str(root), N_FRAMES, H, W)


def assert_samples_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key in ('rgb_context', 'rgb_context_original', 'pose_context'):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=key)


KWARGS = {
    'depth': dict(depth_type='groundtruth', input_depth_type='velodyne'),
    'all-frames': dict(),
    'context': dict(back_context=1, forward_context=1, with_pose=True),
    'context-gt': dict(depth_type='groundtruth', back_context=1, forward_context=1),
    'stride-2': dict(back_context=1, forward_context=1, strides=(2,)),
    'back-2': dict(back_context=2, forward_context=0, with_pose=True),
    'strides-1-2': dict(back_context=1, forward_context=1, strides=(1, 2)),
}


@pytest.mark.parametrize('case', list(KWARGS))
def test_samples_match_jax(tree, case):
    root, split = tree
    ds = KITTIDataset(root, split, **KWARGS[case])
    jds = JaxKITTIDataset(root, split, **KWARGS[case])
    assert len(ds) == len(jds) > 0
    assert ds.paths == jds.paths and ds._context == jds._context
    for i in range(len(ds)):
        assert_samples_equal(ds[i], jds[i])


def test_split_filtering_and_contexts(tree):
    """Frame 4 has no ground truth; windows leave the drive at its ends."""
    root, split = tree
    assert len(KITTIDataset(root, split)) == N_FRAMES
    gt = KITTIDataset(root, split, depth_type='groundtruth')
    assert len(gt) == N_FRAMES - 1 and all('0000000004' not in p for p in gt.paths)
    ctx = KITTIDataset(root, split, back_context=1, forward_context=1, with_pose=True)
    assert len(ctx) == N_FRAMES - 2
    s = ctx[0]
    assert len(s['rgb_context']) == len(s['pose_context']) == 2
    np.testing.assert_allclose(s['intrinsics'], [[0.58 * W, 0, W / 2], [0, 1.92 * H, H / 2],
                                                 [0, 0, 1]])
    assert len(KITTIDataset(root, split, back_context=1, forward_context=1,
                            strides=(2,))) == N_FRAMES - 4


def test_train_transforms_match_jax(tree):
    """Through the train transforms (resize to half size, the unaugmented
    copies, numpy): the contexts, their originals and the scaled
    intrinsics equal JAX's."""
    root, split = tree
    kwargs = dict(image_shape=(H // 2, W // 2), jittering=(), crop_train_borders=(),
                  crop_eval_borders=(), lidar_scale=(), lidar_add=(), lidar_drop_rate=0.0)
    common = dict(depth_type='groundtruth', input_depth_type='velodyne',
                  back_context=1, forward_context=1)
    ds = DATASET_REGISTRY['KITTI'](root_dir=root, file_list=split,
                                   data_transform=get_transforms('train', **kwargs),
                                   intrinsics=None, **common)
    jds = JaxKITTIDataset(root, split, data_transform=jget_transforms('train', **kwargs),
                          **common)
    assert isinstance(ds, KITTIDataset) and len(ds) == len(jds) == N_FRAMES - 3
    for i in range(len(ds)):
        got = ds[i]
        assert got['rgb_context'][0].shape == (H // 2, W // 2, 3)
        assert_samples_equal(got, jds[i])
