"""Loss bookkeeping helpers: counterpart of
``mindtheedge_tpu/losses/loss_base.py`` (reference ``losses/loss_base.py``)."""

import numpy as np


class ProgressiveScaling:
    """The number of active loss scales as training progresses (reference
    ``loss_base.py:10-49``): from ``num_scales`` down to 1 over the
    ``progressive_scaling`` fraction of training."""

    def __init__(self, progressive_scaling, num_scales=4):
        self.num_scales = num_scales
        if progressive_scaling > 0.0:
            self.progressive_scaling = np.float32(
                [progressive_scaling * (i + 1) / (num_scales - 1)
                 for i in range(num_scales - 1)] + [1.0])
        else:
            self.progressive_scaling = progressive_scaling

    def __call__(self, progress):
        if isinstance(self.progressive_scaling, float):
            return self.num_scales
        return int(self.num_scales -
                   np.searchsorted(self.progressive_scaling, progress))


class LossBase:
    """Metric store mixin (reference ``loss_base.py``)."""

    def __init__(self):
        self._metrics = {}

    @property
    def metrics(self):
        return self._metrics

    def add_metric(self, key, value):
        self._metrics[key] = value
