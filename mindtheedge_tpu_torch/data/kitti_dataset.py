"""KITTI raw-sync dataset: counterpart of
``mindtheedge_tpu/data/kitti_dataset.py:35-247``, copied (reference
``datasets/kitti_dataset.py:52-437``).

A split file lists image paths under the KITTI raw layout
(``<date>/<drive>_sync/image_0X/data/<frame>.png``); everything else is
derived from that path: annotated / velodyne depth via the KITTI-depth
layout, per-drive calibration intrinsics, and oxts-chain poses for context
supervision.  The split keeps the frames whose requested depth maps exist;
with ``back_context`` / ``forward_context`` it keeps the frames with a full
window of context frames at each of ``strides``, and a sample then carries
``rgb_context`` (and ``pose_context`` with ``with_pose``).

Divergence (documented, as in the JAX package): the reference hard-codes
its cluster's ``KITTI_depth`` prefix (``kitti_dataset.py:188-191``); here it
is the ``depth_root`` parameter,
``<root_dir>/KITTI_depth`` by default, with the same layout convention.
"""

import functools
import glob
import os

import numpy as np

from mindtheedge_tpu_torch.data.kitti_utils import (
    read_calib_file, transform_from_rot_trans, pose_from_oxts_packet,
    invert_pose_numpy)
from mindtheedge_tpu_torch.data.readers import load_image

_CAMERAS = ('image_02', 'image_03')          # left, right
_DEPTH_LAYOUT = {                            # kind -> (subdir, folder word)
    'groundtruth': ('train', 'groundtruth'),
    'velodyne': (os.path.join('data_depth_velodyne', 'train'),
                 'velodyne_raw'),
}


# ---------------------------------------------------------------- path algebra
def _camera_of(image_path):
    for cam in _CAMERAS:
        if cam in image_path:
            return cam
    return None


def _date_dir(image_path):
    """``.../<date>/<drive>_sync/image_0X/data/<frame>.png`` -> the <date>
    directory holding the calib files (four levels up)."""
    return os.path.abspath(os.path.join(image_path, '../../../..'))


def _frame_sibling(image_path, frame_index):
    """Same drive/camera, another frame index (zero-padded like the base)."""
    stem, ext = os.path.splitext(os.path.basename(image_path))
    return os.path.join(os.path.dirname(image_path),
                        str(frame_index).zfill(len(stem)) + ext)


def depth_file_for(image_path, kind, depth_root):
    """Map a raw image path into the KITTI-depth tree:
    ``<depth_root>/<subdir>/<drive>_sync/proj_depth/<word>/<cam>/<frame>.png``.
    Returns None for unknown kinds or non-camera paths."""
    cam = _camera_of(image_path)
    if kind not in _DEPTH_LAYOUT or cam is None:
        return None
    subdir, word = _DEPTH_LAYOUT[kind]
    drive = os.path.basename(image_path.split('sync')[0]) + 'sync'
    frame = os.path.basename(image_path).strip()
    return os.path.join(depth_root, subdir, drive, 'proj_depth', word,
                        cam, frame)


def load_depth(path):
    """Read a KITTI depth map ([H,W,1] float32, metres; invalid = -1)."""
    if path.endswith('.npz'):
        d = np.load(path)['velodyne_depth'].astype(np.float32)
        return d[..., None]
    raw = np.array(load_image(path), dtype=int)
    assert raw.max() > 255, 'Wrong .png depth file'
    d = raw.astype(np.float32) / 256.0
    d[raw == 0] = -1.0
    return d[..., None]


# --------------------------------------------------------------- drive metadata
@functools.lru_cache(maxsize=None)
def _drive_calib(date_dir):
    return read_calib_file(os.path.join(date_dir, 'calib_cam_to_cam.txt'))


@functools.lru_cache(maxsize=None)
def _imu_to_cam(date_dir):
    """imu -> rectified-camera transform chain of a drive date."""
    cam2cam = _drive_calib(date_dir)
    velo2cam = read_calib_file(
        os.path.join(date_dir, 'calib_velo_to_cam.txt'))
    imu2velo = read_calib_file(
        os.path.join(date_dir, 'calib_imu_to_velo.txt'))
    rect = transform_from_rot_trans(cam2cam['R_rect_00'], np.zeros(3))
    return (rect
            @ transform_from_rot_trans(velo2cam['R'], velo2cam['T'])
            @ transform_from_rot_trans(imu2velo['R'], imu2velo['T']))


@functools.lru_cache(maxsize=None)
def _oxts_packet(oxts_path):
    return np.loadtxt(oxts_path, delimiter=' ')


@functools.lru_cache(maxsize=None)
def _frames_in(folder, ext):
    return len(glob.glob(os.path.join(folder, '*' + ext)))


def _intrinsics_of(image_path):
    cam = _camera_of(image_path)
    calib = _drive_calib(_date_dir(image_path))
    proj = np.reshape(calib[cam.replace('image', 'P_rect')], (3, 4))
    return proj[:, :3]


def _pose_of(image_path):
    """Odometry pose of a frame in its drive's rectified-camera frame,
    relative to frame 0 (oxts chain, reference ``kitti_dataset.py:283-331``)."""
    oxts0 = _oxts_packet(_oxts_path(_frame_sibling(image_path, 0)))
    scale = np.cos(oxts0[0] * np.pi / 180.0)
    origin = transform_from_rot_trans(*pose_from_oxts_packet(oxts0, scale))
    packet = _oxts_packet(_oxts_path(image_path))
    world = transform_from_rot_trans(*pose_from_oxts_packet(packet, scale))
    imu2cam = _imu_to_cam(_date_dir(image_path))
    return (imu2cam @ np.linalg.inv(origin) @ world
            @ np.linalg.inv(imu2cam)).astype(np.float32)


def _oxts_path(image_path):
    cam = _camera_of(image_path)
    if cam is None:
        raise ValueError('Invalid KITTI path for pose supervision.')
    return image_path.replace(cam, 'oxts').replace('.png', '.txt')


# ------------------------------------------------------------ context discovery
def _neighbor_frames(image_path, n_back, n_forward, stride):
    """(back_indices desc, forward_indices asc) of existing context frames,
    or (None, None) when the window leaves the drive."""
    stem, ext = os.path.splitext(os.path.basename(image_path))
    center = int(stem)
    total = _frames_in(os.path.dirname(image_path), ext)
    if center - n_back * stride < 0 or center + n_forward * stride >= total:
        return None, None

    back, i = [], center
    while len(back) < n_back and i > 0:
        i -= stride
        if os.path.exists(_frame_sibling(image_path, i)):
            back.append(i)
    if i < 0:
        return None, None
    forward, i = [], center
    while len(forward) < n_forward and i < total:
        i += stride
        if os.path.exists(_frame_sibling(image_path, i)):
            forward.append(i)
    if i >= total:
        return None, None
    return back, forward


# --------------------------------------------------------------------- dataset
class KITTIDataset:
    """Indexable KITTI-raw sample source feeding ``data/loader.py``.

    Each item is a dict with ``rgb`` (PIL), ``intrinsics`` [3,3], and — per
    the constructor flags — ``depth`` / ``input_depth`` [H,W,1], ``pose``
    [4,4], and per-context ``rgb_context`` / ``pose_context`` lists.
    """

    def __init__(self, root_dir, file_list, train=True, data_transform=None,
                 depth_type=None, input_depth_type=None, with_pose=False,
                 back_context=0, forward_context=0, strides=(1,),
                 depth_root=None):
        assert back_context >= 0 and forward_context >= 0
        self.train = train
        self.split = os.path.splitext(os.path.basename(file_list))[0]
        self.data_transform = data_transform
        self.depth_type = depth_type
        self.input_depth_type = input_depth_type
        self.with_pose = with_pose
        self.n_back, self.n_forward = back_context, forward_context
        self.depth_root = depth_root or os.path.join(root_dir or '',
                                                     'KITTI_depth')

        with open(file_list) as f:
            listed = [ln.split()[0] for ln in f if ln.strip()]
        if root_dir:
            listed = [os.path.join(root_dir, p) for p in listed]
        # keep only frames whose requested depth maps exist on disk
        self.paths = [p for p in listed if self._depths_present(p)]

        # context frames resolved once, per stride, at construction
        self._context = []
        if back_context or forward_context:
            with_ctx = []
            for stride in strides:
                for p in self.paths:
                    back, fwd = _neighbor_frames(
                        p, back_context, forward_context, stride)
                    if back is not None and fwd is not None:
                        with_ctx.append(p)
                        self._context.append(back[::-1] + fwd)
            self.paths = with_ctx

    def _depths_present(self, image_path):
        for kind in (self.input_depth_type, self.depth_type):
            if kind:
                f = depth_file_for(image_path, kind, self.depth_root)
                if f is None or not os.path.exists(f):
                    return False
        return True

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        path = self.paths[idx]
        sample = {
            'idx': idx,
            'filename': '%s_%010d' % (self.split, idx),
            'rgb': load_image(path),
            'intrinsics': _intrinsics_of(path),
        }
        if self.with_pose:
            sample['pose'] = _pose_of(path)
        if self.depth_type:
            sample['depth'] = load_depth(
                depth_file_for(path, self.depth_type, self.depth_root))
        if self.input_depth_type:
            sample['input_depth'] = load_depth(
                depth_file_for(path, self.input_depth_type, self.depth_root))

        if self._context:
            frames = [_frame_sibling(path, i) for i in self._context[idx]]
            sample['rgb_context'] = [load_image(f) for f in frames]
            if self.with_pose:
                sample['pose_context'] = [
                    invert_pose_numpy(_pose_of(f)) @ sample['pose']
                    for f in frames]

        if self.data_transform:
            sample = self.data_transform(sample)
        return sample
