"""Datasets: counterpart of ``mindtheedge_tpu/data/datasets.py``.

``GTADataset`` (reference ``datasets/gta_dataset.py:111-456``) reads
space-separated split columns::

    rgb gt_depth edge lidar seg rgb_edge rgb_edge_for_loss normal

with per-column readers (png/bin/npy), multiscale edge and normal side
files by the ``_000`` -> ``_001..003`` name convention, and the uint8 ->
radians normal decode.  'None' entries are skipped.  The GTA intrinsics
are a parameter, defaulting to the reference's fixed K.  ``KITTI`` names
``data/kitti_dataset.KITTIDataset``.  cv2 and PIL are imported inside the
functions that use them.
"""

import os

import numpy as np

from mindtheedge_tpu_torch.data.readers import (
    GTA_K, depth_read_bin, load_image, process_lidar, read_lidar, read_png_depth)


class GTADataset:
    def __init__(self, root_dir, file_list, train=True, data_transform=None,
                 depth_type=None, input_depth_type=None, with_pose=False,
                 back_context=0, forward_context=0, intrinsics=None):
        self.root_dir = root_dir
        self.train = train
        self.data_transform = data_transform
        self.depth_type = depth_type
        self.with_depth = bool(depth_type)
        self.input_depth_type = input_depth_type
        self.with_input_depth = bool(input_depth_type)
        self.split = os.path.basename(file_list).split('.')[0]
        self.K = GTA_K if intrinsics is None else np.asarray(intrinsics)

        with open(file_list, 'r') as f:
            cols = [ln.strip().split(' ') for ln in f if ln.strip()]

        def col(i):
            return [c[i] if len(c) > i else None for c in cols]

        self.image_paths = col(0)
        self.depth_paths = col(1)
        self.edge_paths = col(2)
        self.lidar_paths = col(3)
        self.seg_paths = [p for p in col(4) if p and p != 'None']
        self.rgb_edge_paths = col(5)
        self.rgb_edge_for_loss_paths = col(6)
        self.normal_paths = col(7)

    def __len__(self):
        return len(self.image_paths)

    @staticmethod
    def _read_map(path):
        import cv2
        ext = path.rsplit('.', 1)[-1]
        if ext == 'png':
            return cv2.imread(path)[:, :, 0]
        if ext == 'npy':
            return np.load(path)
        raise ValueError(f'Unknown map extension {path}')

    @staticmethod
    def _decode_normal(v255):
        return (360.0 * (v255 / 255.0) - 180.0) * (np.pi / 180.0)

    @staticmethod
    def _multiscale(path, decode=None):
        """``_000`` -> ``_001..003`` side files (``gta_dataset.py:363-366``)."""
        import cv2
        base = path.split('_000')[0]
        out = {}
        if os.path.exists(base + '_001.png'):
            for i in range(1, 4):
                m = cv2.imread(base + f'_00{i}.png')[:, :, 0]
                out[i] = decode(m) if decode else m
        return out

    @staticmethod
    def _read_depth(path):
        ext = path.rsplit('.', 1)[-1]
        if ext == 'png':
            return read_png_depth(path)
        if ext == 'bin':
            return depth_read_bin(path)
        if ext == 'npy':
            return np.load(path)
        return None

    def __getitem__(self, idx):
        sample = {
            'idx': idx,
            'filename': '%s_%010d' % (self.split, idx),
            'rgb': load_image(self.image_paths[idx]),
        }
        dp = self.depth_paths[idx]
        if dp and dp != 'None':
            depth = self._read_depth(dp)
            if depth is not None:
                sample['depth'] = depth

        ep = self.edge_paths[idx]
        if ep and ep != 'None':
            sample['edge'] = self._read_map(ep)
            for i, m in self._multiscale(ep).items():
                sample[f'edge_{i}'] = m

        lp = self.lidar_paths[idx]
        if lp and lp != 'None':
            if lp.endswith('.bin'):
                lidar = process_lidar(read_lidar(lp), self.K, sample.get('depth'))
            else:
                lidar = self._read_depth(lp)
            if lidar is not None:
                if self.with_input_depth:
                    sample['input_depth'] = lidar
                sample['lidar'] = lidar

        if self.seg_paths:
            import cv2
            seg = cv2.imread(self.seg_paths[idx])
            sample['seg'] = cv2.cvtColor(seg, cv2.COLOR_BGR2RGB)

        rep = self.rgb_edge_paths[idx]
        if rep and rep != 'None':
            sample['rgb_edge'] = self._read_map(rep)
        rlp = self.rgb_edge_for_loss_paths[idx]
        if rlp and rlp != 'None':
            sample['rgb_edge_for_loss'] = self._read_map(rlp)

        npath = self.normal_paths[idx]
        if npath and npath != 'None':
            decode = lambda v: self._decode_normal(v.astype(np.float64))
            sample['normal'] = decode(self._read_map(npath))
            for i, m in self._multiscale(npath, decode).items():
                sample[f'normal_{i}'] = m

        if 'intrinsics' not in sample:
            sample['intrinsics'] = np.asarray(self.K, dtype=np.float32)
        if self.data_transform:
            sample = self.data_transform(sample)
        return sample


class ConcatDataset:
    """Datasets one after another, each repeated ``repeats[i]`` times
    (``datasets.py:150-168``)."""

    def __init__(self, datasets, repeats=None):
        repeats = repeats or [1] * len(datasets)
        self.entries = [ds for ds, rep in zip(datasets, repeats)
                        for _ in range(max(int(rep), 1))]
        self.cum = np.cumsum([0] + [len(ds) for ds in self.entries])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self.cum[1:], idx, side='right'))
        return self.entries[ds_idx][idx - int(self.cum[ds_idx])]


def _kitti(*args, **kwargs):
    """``KITTIDataset``, which takes its intrinsics from each drive's
    calibration (``datasets.py:171-174``)."""
    from mindtheedge_tpu_torch.data.kitti_dataset import KITTIDataset
    kwargs.pop('intrinsics', None)
    return KITTIDataset(*args, **kwargs)


DATASET_REGISTRY = {
    'GTA': GTADataset,
    'KITTI': _kitti,
}


def register_dataset(name, cls):
    """Make ``datasets.<mode>.dataset: [name]`` build ``cls``
    (``datasets.py:183-184``)."""
    DATASET_REGISTRY[name] = cls
