"""Small helpers: counterpart of ``mindtheedge_tpu/utils/misc.py``
(reference ``utils/misc.py``)."""

from mindtheedge_tpu_torch.data.augmentations import parse_crop_borders  # noqa: F401


def filter_dict(dictionary, keywords):
    """The keys of ``keywords`` present in ``dictionary``."""
    return [key for key in keywords if key in dictionary]


def make_list(var, n=None):
    """``var`` as a list, broadcast to length ``n`` if given."""
    var = var if isinstance(var, list) else [var]
    if n is None:
        return var
    if len(var) == 1:
        return var * n
    if len(var) != n:
        raise ValueError('Wrong list length for make_list')
    return var


def same_shape(shape1, shape2):
    return tuple(shape1) == tuple(shape2)
