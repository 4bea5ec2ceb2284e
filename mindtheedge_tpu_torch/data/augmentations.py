"""Host-side sample augmentations (numpy/PIL), exact reference semantics:
counterpart of ``mindtheedge_tpu/data/augmentations.py``.

``resize_depth_preserve`` is the sparse-preserving resize that scatters
valid depth points into the downsampled grid instead of interpolating
(reference ``datasets/augmentations.py:58-100``).  Its int truncation and
its row-major write order on collisions are kept exactly: the AUC metric
depends on them.

``colorjitter_sample`` applies torchvision's PIL colour adjustments
(brightness, contrast and saturation by ``ImageEnhance``, hue by a shift of
the HSV hue byte) written out with PIL, so it needs no torchvision.  The
JAX package calls torchvision and skips the jitter where it is missing.
cv2 and PIL are imported inside the functions that use them.
"""

import random

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


def resize_depth(depth, shape):
    """Nearest-neighbour depth resize (``augmentations.py:37-55``)."""
    import cv2
    depth = cv2.resize(np.squeeze(depth), dsize=(shape[1], shape[0]),
                       interpolation=cv2.INTER_NEAREST)
    return np.expand_dims(depth, axis=2)


# -- sample-level ops (dict of numpy/PIL entries) -------------------------------

IMAGE_KEYS = ('rgb', 'rgb_original', 'target_rgb', 'target_rgb_original')
DEPTH_PRESERVE_KEYS = (
    'depth', 'input_depth', 'lidar', 'edge', 'rgb_edge', 'rgb_edge_for_loss',
    'target_edge', 'target_rgb_edge', 'target_rgb_edge_for_loss',
    'target_depth', 'target_input_depth')
EDGE_KEYS = ('edge', 'rgb_edge', 'rgb_edge_for_loss', 'target_edge',
             'target_rgb_edge', 'target_rgb_edge_for_loss')
NUMPY_KEYS = ('rgb', 'rgb_original', 'depth', 'input_depth', 'edge', 'rgb_edge',
              'rgb_edge_for_loss', 'edge_1', 'edge_2', 'edge_3', 'edge_4',
              'edge_5', 'seg', 'lidar', 'target_rgb', 'target_rgb_original',
              'target_depth', 'target_input_depth', 'target_edge',
              'target_rgb_edge', 'target_rgb_edge_for_loss', 'normal',
              'normal_1', 'normal_2', 'normal_3')


def resize_sample(sample, shape):
    """Resize a whole sample dict (``augmentations.py:71-108``): images by
    ANTIALIAS, depths and edges by the sparse-preserving scatter (edges in
    0..255 divided by 255), normals bilinearly, scale s of the multiscale
    edges and normals to shape / 2**s, and the intrinsics."""
    import cv2
    if 'intrinsics' in sample:
        orig_w, orig_h = sample['rgb'].size
        K = np.copy(sample['intrinsics'])
        K[0] *= shape[1] / orig_w
        K[1] *= shape[0] / orig_h
        sample['intrinsics'] = K
    for key in IMAGE_KEYS:
        if key in sample:
            sample[key] = resize_image(sample[key], shape)
    if 'seg' in sample:
        sample['seg'] = cv2.resize(sample['seg'], (shape[1], shape[0]),
                                   interpolation=cv2.INTER_NEAREST)
    if 'rgb_context' in sample:
        sample['rgb_context'] = [resize_image(k, shape) for k in sample['rgb_context']]
    for key in DEPTH_PRESERVE_KEYS:
        if key in sample:
            sample[key] = resize_depth_preserve(sample[key], shape)
            if key in EDGE_KEYS and np.max(sample[key]) > 1:
                sample[key] = sample[key] / 255
    if 'normal' in sample:
        sample['normal'] = cv2.resize(sample['normal'], (shape[1], shape[0]))
    for s in range(1, 4):
        ek, nk = f'edge_{s}', f'normal_{s}'
        cur_shape = (int(shape[0] / 2 ** s), int(shape[1] / 2 ** s))
        if ek in sample:
            sample[ek] = resize_depth_preserve(sample[ek], cur_shape)
            if np.max(sample[ek]) > 1:
                sample[ek] = sample[ek] / 255
        if nk in sample:
            sample[nk] = cv2.resize(sample[nk], (cur_shape[1], cur_shape[0]))
    if 'depth_context' in sample:
        sample['depth_context'] = [resize_depth_preserve(k, shape)
                                   for k in sample['depth_context']]
    return sample


def duplicate_sample(sample):
    """Unaugmented copies for the photometric loss (``augmentations.py:111-118``)."""
    for key in ('rgb', 'target_rgb'):
        if key in sample:
            sample[f'{key}_original'] = sample[key].copy()
    if 'rgb_context' in sample:
        sample['rgb_context_original'] = [k.copy() for k in sample['rgb_context']]
    return sample


def _adjust_hue(image, factor):
    """torchvision's PIL ``adjust_hue``: shift the HSV hue byte by
    ``factor * 255``, wrapping."""
    from PIL import Image
    if image.mode in ('L', '1', 'I', 'F'):
        return image
    h, s, v = image.convert('HSV').split()
    np_h = np.array(h, dtype=np.uint8)
    with np.errstate(over='ignore'):
        np_h += np.array(factor * 255).astype(np.uint8)
    return Image.merge('HSV', (Image.fromarray(np_h, 'L'), s, v)).convert(image.mode)


def colorjitter_sample(sample, parameters, prob=1.0):
    """Colour jitter (``augmentations.py:121-151``): brightness, contrast,
    saturation and hue factors drawn from ``random``, applied in a shuffled
    order to the images of the sample."""
    if random.random() >= prob:
        return sample
    from PIL import ImageEnhance
    brightness, contrast, saturation, hue = parameters[:4]
    b = random.uniform(max(0, 1 - brightness), 1 + brightness)
    c = random.uniform(max(0, 1 - contrast), 1 + contrast)
    s = random.uniform(max(0, 1 - saturation), 1 + saturation)
    hh = random.uniform(-hue, hue)
    fns = [lambda im: ImageEnhance.Brightness(im).enhance(b),
           lambda im: ImageEnhance.Contrast(im).enhance(c),
           lambda im: ImageEnhance.Color(im).enhance(s),
           lambda im: _adjust_hue(im, hh)]
    random.shuffle(fns)

    def apply(im):
        for f in fns:
            im = f(im)
        return im

    for key in ('rgb', 'target_rgb'):
        if key in sample:
            sample[key] = apply(sample[key])
    if 'rgb_context' in sample:
        sample['rgb_context'] = [apply(k) for k in sample['rgb_context']]
    return sample


def crop_image(image, borders):
    return image.crop(borders)


def crop_depth(depth, borders):
    if depth is None:
        return depth
    return depth[borders[1]:borders[3], borders[0]:borders[2]]


def crop_sample(sample, borders):
    """Crop inputs and supervision (``augmentations.py:164-180``)."""
    if 'intrinsics' in sample:
        K = np.copy(sample['intrinsics'])
        K[0, 2] -= borders[0]
        K[1, 2] -= borders[1]
        sample['intrinsics'] = K
    for key in IMAGE_KEYS:
        if key in sample:
            sample[key] = crop_image(sample[key], borders)
    if 'rgb_context' in sample:
        sample['rgb_context'] = [crop_image(v, borders) for v in sample['rgb_context']]
    for key in ('input_depth', 'rgb_edge', 'depth', 'edge', 'lidar', 'normal',
                'seg', 'target_depth', 'target_input_depth'):
        if key in sample:
            sample[key] = crop_depth(sample[key], borders)
    return sample


def to_numpy_sample(sample):
    """HWC float32 arrays (``augmentations.py:183-213``); images and uint8
    maps divided by 255."""
    from PIL import Image

    def convert(v):
        if isinstance(v, Image.Image):
            arr = np.asarray(v, dtype=np.float32) / 255.0
        else:
            arr = np.asarray(v)
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            arr = arr.astype(np.float32)
        return arr[:, :, None] if arr.ndim == 2 else arr

    for key in NUMPY_KEYS:
        if key in sample:
            sample[key] = convert(sample[key])
    for key in ('rgb_context', 'rgb_context_original', 'depth_context'):
        if key in sample:
            sample[key] = [convert(k) for k in sample[key]]
    if 'intrinsics' in sample:
        sample['intrinsics'] = np.asarray(sample['intrinsics'], dtype=np.float32)
    return sample


def parse_crop_borders(borders, shape):
    """Int/float/2-or-4-tuple crop-border semantics (``utils/misc.py:78-147``)."""
    if len(borders) == 0:
        return 0, 0, shape[1], shape[0]
    if len(borders) == 2:
        borders = (0, borders[0], shape[1], borders[1]) if borders[0] <= 0 else \
            (borders[0], 0, shape[1] - borders[0], borders[1])
    if len(borders) == 4:
        out = list(borders)
        for i, (v, dim) in enumerate(zip(out, (shape[1], shape[0], shape[1], shape[0]))):
            if isinstance(v, float):
                out[i] = int(v * dim)
            elif v < 0 or (i >= 2 and v <= 0):
                out[i] = v + dim
        return tuple(out)
    raise ValueError(f'Invalid crop borders {borders}')
