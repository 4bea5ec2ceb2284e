"""Train, validation and test sample pipelines: counterpart of
``mindtheedge_tpu/data/transforms.py`` (reference ``datasets/transforms.py``).
Every pipeline ends in channel-last float32 numpy; the loader collates
those, and the trainer moves a batch to the card.
"""

from functools import partial

import numpy as np

from mindtheedge_tpu_torch.data.augmentations import (
    colorjitter_sample, crop_sample, duplicate_sample, parse_crop_borders,
    resize_depth, resize_depth_preserve, resize_image, resize_sample,
    to_numpy_sample)


def augment_depth_values(sample, scale_range, add_range, drop_rate=0.1):
    """LiDAR point augmentation (``transforms.py:17-60``, reference
    ``utils/depth.py:366-466``): per-point jitter of (i, j, d), points moved
    off the image dropped, then a random ``drop_rate`` share dropped; draws
    from ``np.random``."""
    if sample is None:
        return sample
    arr = np.squeeze(np.asarray(sample))
    rows, cols = arr.shape
    ii, jj = np.where(arr > 0)
    d = arr[ii, jj]
    n = len(d)
    if n == 0:
        return np.expand_dims(arr, 2)
    scale_range = np.array(scale_range)
    add_range = np.array(add_range)

    def rand_scale(lo, hi, m):
        if lo is None or hi is None or lo == hi:
            return np.ones(m)
        s = lo + np.random.rand(m) * (hi - lo)
        inv = np.random.rand(m) < 0.5
        s[inv] = 1.0 / s[inv]
        return s

    def rand_add(lo, hi, m, neg=True):
        if lo is None or hi is None or lo == hi:
            return np.zeros(m)
        a = lo + np.random.rand(m) * (hi - lo)
        if neg:
            flip = np.random.rand(m) < 0.5
            a[flip] = -a[flip]
        return a

    d = rand_add(*add_range[:, 2], n, neg=False) + d * rand_scale(*scale_range[:, 2], 1)[0]
    ii = np.round(ii + rand_add(*add_range[:, 0], n)).astype(int)
    jj = np.round(jj + rand_add(*add_range[:, 1], n)).astype(int)
    ok = (ii >= 0) & (ii < rows) & (jj >= 0) & (jj < cols)
    ii, jj, d = ii[ok], jj[ok], d[ok]
    keep = np.sort(np.random.permutation(len(d))[:len(d) - int(round(len(d) * drop_rate))])
    out = np.zeros((rows, cols))
    out[ii[keep], jj[keep]] = d[keep]
    return np.expand_dims(out, 2)


def train_transforms(sample, image_shape, jittering, crop_train_borders,
                     lidar_scale, lidar_add, lidar_drop_rate):
    """``transforms.py:63-78``: crop -> resize -> duplicate -> jitter ->
    LiDAR augmentation -> numpy."""
    if len(crop_train_borders) > 0:
        borders = parse_crop_borders(crop_train_borders, sample['rgb'].size[::-1])
        sample = crop_sample(sample, borders)
    if len(image_shape) > 0:
        sample = resize_sample(sample, image_shape)
    sample = duplicate_sample(sample)
    if len(jittering) > 0:
        sample = colorjitter_sample(sample, jittering)
    if len(lidar_scale) > 0 and len(lidar_add) > 0 and 'input_depth' in sample:
        sample['input_depth'] = augment_depth_values(
            sample['input_depth'], lidar_scale, lidar_add, lidar_drop_rate)
    return to_numpy_sample(sample)


def validation_transforms(sample, image_shape, crop_eval_borders):
    """``transforms.py:81-106``: size rounded down to a multiple of 32, image
    resize, sparse-preserving LiDAR resize, edges by cv2."""
    import cv2
    if len(crop_eval_borders) > 0:
        borders = parse_crop_borders(crop_eval_borders, sample['rgb'].size[::-1])
        sample = crop_sample(sample, borders)
    w, h = sample['rgb'].size
    shape = (h - h % 32, w - w % 32)
    sample['rgb'] = resize_image(sample['rgb'], shape)
    if 'input_depth' in sample:
        sample['input_depth'] = resize_depth_preserve(sample['input_depth'], shape)
    if 'edge' in sample:
        sample['edge'] = cv2.resize(np.squeeze(sample['edge']), (shape[1], shape[0]))
    for i in range(1, 6):
        key = f'edge_{i}'
        if key in sample:
            sample[key] = cv2.resize(np.squeeze(sample[key]),
                                     (shape[1] // 2 ** i, shape[0] // 2 ** i))
    if 'rgb_edge' in sample:
        sample['rgb_edge'] = cv2.resize(np.squeeze(sample['rgb_edge']),
                                        (shape[1], shape[0]))
    return to_numpy_sample(sample)


def test_transforms(sample, image_shape, crop_eval_borders):
    """``transforms.py:109-118``."""
    if len(crop_eval_borders) > 0:
        borders = parse_crop_borders(crop_eval_borders, sample['rgb'].size[::-1])
        sample = crop_sample(sample, borders)
    if len(image_shape) > 0:
        sample['rgb'] = resize_image(sample['rgb'], image_shape)
        if 'input_depth' in sample:
            sample['input_depth'] = resize_depth(sample['input_depth'], image_shape)
    return to_numpy_sample(sample)


def get_transforms(mode, image_shape, jittering, crop_train_borders,
                   crop_eval_borders, lidar_scale, lidar_add,
                   lidar_drop_rate, **kwargs):
    if mode == 'train':
        return partial(train_transforms, image_shape=image_shape,
                       jittering=jittering,
                       crop_train_borders=crop_train_borders,
                       lidar_scale=lidar_scale, lidar_add=lidar_add,
                       lidar_drop_rate=lidar_drop_rate)
    if mode == 'validation':
        return partial(validation_transforms, image_shape=image_shape,
                       crop_eval_borders=crop_eval_borders)
    if mode == 'test':
        return partial(test_transforms, image_shape=image_shape,
                       crop_eval_borders=crop_eval_borders)
    raise ValueError(f'Unknown mode {mode}')
