"""KITTI raw-devkit helpers: calibration files, the oxts pose chain, the
numpy pose inverse.  Counterpart of ``mindtheedge_tpu/data/kitti_utils.py:12-65``,
copied whole (reference ``datasets/kitti_dataset_utils.py``): Mercator
projection for translation, R = Rz(yaw) Ry(pitch) Rx(roll).
"""

import numpy as np

EARTH_RADIUS = 6378137.0


def read_calib_file(filepath):
    """Parse 'key: v1 v2 ...' calibration files into numpy arrays."""
    data = {}
    with open(filepath, 'r') as f:
        for line in f:
            if ':' not in line:
                continue
            key, value = line.split(':', 1)
            try:
                data[key.strip()] = np.asarray(
                    [float(x) for x in value.split()])
            except ValueError:
                data[key.strip()] = value.strip()
    return data


def transform_from_rot_trans(R, t):
    """[4,4] transform from flattened rotation and translation."""
    R = np.asarray(R, dtype=np.float64).reshape(3, 3)
    t = np.asarray(t, dtype=np.float64).reshape(3, 1)
    return np.vstack((np.hstack([R, t]), [0, 0, 0, 1]))


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def pose_from_oxts_packet(raw_data, scale):
    """(R, t) from an oxts packet row; Mercator projection at given scale."""
    lat, lon, alt = raw_data[0], raw_data[1], raw_data[2]
    roll, pitch, yaw = raw_data[3], raw_data[4], raw_data[5]
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    t = np.array([tx, ty, alt])
    R = rotz(yaw) @ roty(pitch) @ rotx(roll)
    return R, t


def invert_pose_numpy(T):
    Tinv = np.copy(T)
    R, t = Tinv[:3, :3], Tinv[:3, 3]
    Tinv[:3, :3], Tinv[:3, 3] = R.T, -np.matmul(R.T, t)
    return Tinv
