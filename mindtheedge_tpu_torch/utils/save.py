"""Prediction saving helpers: counterpart of ``mindtheedge_tpu/utils/save.py``
(reference ``utils/save.py``).  matplotlib and cv2 are imported only by the
functions that draw or write images.
"""

import os

import numpy as np


def save_paths_list(paths, folder, filename='pred_list.txt'):
    """One path a line into ``folder/filename`` -> the file's path."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, filename)
    with open(path, 'w') as f:
        f.writelines(p + '\n' for p in paths)
    return path


def viz_inv_depth(inv_depth, normalizer=None, percentile=95,
                  colormap='plasma', filter_zeros=False):
    """Inverse depth -> RGB colour map in [0, 1] (reference
    ``utils/depth.py:67-101``); needs matplotlib."""
    from matplotlib import colormaps
    inv_depth = np.asarray(inv_depth, dtype=np.float64).squeeze()
    cm = colormaps.get_cmap(colormap)
    if normalizer is None:
        vals = inv_depth[inv_depth > 0] if filter_zeros else inv_depth
        normalizer = np.percentile(vals, percentile)
    inv_depth = inv_depth / (normalizer + 1e-6)
    return cm(np.clip(inv_depth, 0.0, 1.0))[:, :, :3]


def save_depth(path, depth, save_npz=True, save_png=True, save_viz=True,
               rgb=None, save_rgb=True):
    """Write the npz, uint16 png, viz and rgb outputs of one prediction
    (reference ``utils/save.py:19-76``)."""
    import cv2
    base = path[:-4] if path.endswith(('.png', '.npz')) else path
    os.makedirs(os.path.dirname(base) or '.', exist_ok=True)
    depth = np.asarray(depth).squeeze()
    if save_npz:
        np.savez_compressed(base + '.npz', depth=depth)
    if save_png:
        cv2.imwrite(base + '.png', (depth * 256).astype(np.uint16))
    if save_viz:
        inv = np.where(depth > 0, 1.0 / np.clip(depth, 1e-6, None), 0.0)
        viz = (viz_inv_depth(inv) * 255).astype(np.uint8)
        cv2.imwrite(base + '_viz.png', viz[:, :, ::-1])
    if save_rgb and rgb is not None:
        rgb = np.asarray(rgb).squeeze()
        cv2.imwrite(base + '_rgb.png', (rgb * 255).astype(np.uint8)[:, :, ::-1])
