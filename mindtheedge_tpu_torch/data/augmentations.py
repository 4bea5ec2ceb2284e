"""Host-side resizes (numpy/PIL), exact reference semantics: counterpart of
``mindtheedge_tpu/data/augmentations.py:21-57`` (``resize_image``,
``resize_depth_preserve``).  The sample-level augmentations wait for the
training slice (ROADMAP Slice C).

``resize_depth_preserve`` is the sparse-preserving resize that scatters
valid depth points into the downsampled grid instead of interpolating
(reference ``datasets/augmentations.py:58-100``).  Its int truncation and
its row-major write order on collisions are kept exactly: the AUC metric
depends on them.
"""

import numpy as np


def resize_image(image, shape, interpolation=None):
    """PIL resize to (H, W), ANTIALIAS by default (``augmentations.py:16-35``;
    Pillow's ANTIALIAS is its LANCZOS filter)."""
    if interpolation is None:
        from PIL import Image
        interpolation = Image.LANCZOS
    return image.resize((shape[1], shape[0]), interpolation)


def resize_depth_preserve(depth, shape):
    """Sparse-preserving resize: scatter valid points (``augmentations.py:58-100``).

    Multiple source points may land in one target pixel; the reference's
    write order (row-major over the flattened source) decides collisions, and
    the coordinate mapping uses int() truncation — both preserved.
    """
    if depth is None:
        return depth
    depth = np.squeeze(depth)
    h, w = depth.shape
    x = depth.reshape(-1)
    uv = np.mgrid[:h, :w].transpose(1, 2, 0).reshape(-1, 2)
    idx = x > 0
    crd, val = uv[idx], x[idx]
    crd = crd.astype(np.float64)
    crd[:, 0] = (crd[:, 0] * (shape[0] / h)).astype(np.int32)
    crd[:, 1] = (crd[:, 1] * (shape[1] / w)).astype(np.int32)
    crd = crd.astype(np.int32)
    inside = (crd[:, 0] < shape[0]) & (crd[:, 1] < shape[1])
    crd, val = crd[inside], val[inside]
    out = np.zeros(shape)
    out[crd[:, 0], crd[:, 1]] = val
    return np.expand_dims(out, axis=2)
