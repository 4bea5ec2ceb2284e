"""File readers: images, depth maps (png/npz/npy/bin), lidar point clouds.
Counterpart of ``mindtheedge_tpu/data/readers.py``, copied whole.

Host-side IO matching the reference readers exactly:
* ``read_png_depth``: uint16 png / 256, zeros -> -1 (``kitti_dataset.py:40-46``)
* ``read_npz_depth``: .npz by key (``kitti_dataset.py:35-38``)
* ``read_lidar`` / ``process_lidar``: GTA KITTI-format .bin point cloud
  projected by fixed K=[960,0,960;0,960,540;0,0,1], 10cm-error filtering vs
  GT (``gta_dataset.py:39-104``)
* ``depth_read_bin`` / ``ndc_to_depth``: GTA NDC depth (``gta_dataset.py:431-452``)

PIL is imported only by the functions that read images.
"""

import numpy as np

GTA_K = np.array([960, 0, 960, 0, 960, 540, 0, 0, 1], dtype=np.float64).reshape(3, 3)


def load_image(path):
    """Read an image with PIL, converting RGBA -> RGB (reference edge.py:9-27)."""
    from PIL import Image
    im = Image.open(path)
    if im.mode == 'RGBA':
        im = im.convert('RGB')
    return im


def read_png_depth(file):
    """uint16 png depth / 256; invalid (0) pixels -> -1."""
    depth_png = np.array(load_image(file), dtype=int)
    depth = depth_png.astype(np.float32) / 256.0
    depth[depth_png == 0] = -1.0
    return depth


def read_npz_depth(file, depth_type='velodyne'):
    depth = np.load(file)[depth_type].astype(np.float32)
    return depth


def read_npy_depth(file):
    return np.load(file).astype(np.float32)


def read_depth_any(file):
    ext = file.rsplit('.', 1)[-1]
    if ext == 'png':
        return read_png_depth(file)
    if ext == 'npz':
        return read_npz_depth(file)
    if ext == 'npy':
        return read_npy_depth(file)
    raise ValueError(f'Unknown depth extension: {file}')


def read_lidar(filepath):
    """KITTI-format .bin point cloud -> [3,N] in GTA camera axes
    (``gta_dataset.py:39-80``: (x,y,z,i) -> (-y,-z,x), NaNs dropped)."""
    data = np.fromfile(filepath, np.single).reshape(-1, 4)
    pts = np.vstack((-data[:, 1], -data[:, 2], data[:, 0])).T
    pts = pts[~np.any(np.isnan(pts), axis=1)].T
    return pts


def process_lidar(raw_lidar_map, K=GTA_K, depth_map=None, shape=(1080, 1920)):
    """Project [3,N] points to a sparse depth image (``gta_dataset.py:85-104``)."""
    lidar_mat = np.zeros(shape)
    p = K @ raw_lidar_map
    p_norm = p / p[2, :]
    in_range = ((p_norm[0, :] >= 0) & (p_norm[0, :] < shape[1]) &
                (p_norm[1, :] >= 0) & (p_norm[1, :] < shape[0]))
    p_norm = p_norm[:, in_range].astype('int')
    p = p[:, in_range]
    lidar_mat[p_norm[1, :], p_norm[0, :]] = p[2, :]
    if depth_map is not None:
        err = np.sqrt((lidar_mat - depth_map) ** 2)
        lidar_mat[(err > 0.1) & (lidar_mat > 0)] = 0
    return lidar_mat


def ndc_to_depth(ndc, nc_z=0.15, fc_z=600.0):
    """GTA NDC -> metric depth (``gta_dataset.py:431-442``)."""
    depth = nc_z / (ndc + (nc_z * nc_z / (2 * fc_z)))
    depth[ndc == 0.0] = fc_z
    return depth


def depth_read_bin(filename, rows=1080, cols=1920):
    ndc = np.fromfile(filename, dtype=np.float32, count=rows * cols).reshape(rows, cols)
    return ndc_to_depth(ndc)
