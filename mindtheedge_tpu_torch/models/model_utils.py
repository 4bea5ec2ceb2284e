"""Model output and batch helpers on NHWC tensors: counterpart of
``mindtheedge_tpu/models/model_utils.py`` (reference ``models/model_utils.py``)."""

from mindtheedge_tpu_torch.utils.image import flip_lr, interpolate_image

FLIP_KEYS = ('rgb', 'rgb_original', 'input_depth', 'rgb_edge', 'depth',
             'edge', 'normal')


def merge_outputs(*outputs):
    """Merge output dicts; 'metrics' dicts union, other keys must be unique
    (reference ``model_utils.py:34-66``)."""
    ignore = ('boxes', 'depth', 'confidence')
    merged = {'metrics': {}}
    for output in outputs:
        for key, val in output.items():
            if key == 'metrics':
                merged['metrics'].update(val)
            elif key not in ignore:
                if key in merged:
                    raise KeyError(f'Duplicated output key {key}')
                merged[key] = val
    return merged


def stack_batch(batch):
    """Fold a multi-camera dim [B,N,H,W,C] into the batch dim
    (reference ``model_utils.py:69-95``)."""
    if 'rgb' in batch and batch['rgb'].ndim == 5:
        for key, val in batch.items():
            if hasattr(val, 'ndim') and val.ndim > 1:
                batch[key] = val.reshape((-1,) + tuple(val.shape[2:]))
    return batch


def flip_batch_input(batch):
    """Horizontally flip the network inputs (reference ``model_utils.py:98-125``)."""
    out = dict(batch)
    for key in FLIP_KEYS:
        if key in out:
            out[key] = flip_lr(out[key])
    if 'rgb_context' in out:
        out['rgb_context'] = [flip_lr(x) for x in out['rgb_context']]
    return out


def flip_output(output):
    """Flip prediction lists back (reference ``model_utils.py:128-151``)."""
    out = dict(output)
    for key in ('inv_depths', 'inv_depths_rgbd'):
        if key in out:
            out[key] = [flip_lr(d) for d in out[key]]
    return out


def upsample_output(output, mode='nearest', align_corners=None):
    """Upsample every scale to the first one's resolution (reference
    ``model_utils.py:154-182``)."""
    out = dict(output)
    for key in ('inv_depths', 'inv_depths_rgbd'):
        if key in out:
            shape = (out[key][0].shape[1], out[key][0].shape[2])
            out[key] = [interpolate_image(d, shape, mode=mode,
                                          align_corners=align_corners)
                        for d in out[key]]
    return out
