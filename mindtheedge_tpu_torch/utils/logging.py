"""Console logging helpers: counterpart of ``mindtheedge_tpu/utils/logging.py``
(reference ``utils/logging.py``)."""

import numpy as np

_COLORS = {'red': 31, 'green': 32, 'yellow': 33, 'blue': 34,
           'magenta': 35, 'cyan': 36, 'white': 37}


def pcolor(string, color, on_color=None, attrs=None):
    """``string`` in an ANSI colour (termcolor's call, no dependency);
    ``on_color`` is accepted and ignored, as there."""
    code = _COLORS.get(color, 37)
    prefix = f'\033[{code}m'
    if attrs and 'bold' in attrs:
        prefix = f'\033[1;{code}m'
    return f'{prefix}{string}\033[0m'


class AvgMeter:
    """Running average over the last ``n_max`` values (reference
    ``utils/logging.py:145-178``)."""

    def __init__(self, n_max=100):
        self.n_max = n_max
        self.values = []

    def __call__(self, value):
        self.values.append(value)
        if len(self.values) > self.n_max:
            self.values.pop(0)
        return self.get()

    def get(self):
        return float(np.mean(self.values)) if self.values else 0.0

    def reset(self):
        self.values.clear()

    def get_and_reset(self):
        average = self.get()
        self.reset()
        return average


def print_metrics_table(title, metrics, fmt='{:.4f}'):
    """Print ``metrics`` (scalars or vectors) as a table under ``title``."""
    if not metrics:
        return
    keys = sorted(metrics)
    width = max(len(k) for k in keys)
    bar = '*' * (width + 14)
    print(pcolor(bar, 'cyan'))
    print(pcolor(f'* {title}', 'cyan', attrs=['bold']))
    for k in keys:
        val = metrics[k]
        if isinstance(val, (list, tuple, np.ndarray)):
            val = ' '.join(fmt.format(float(v)) for v in np.ravel(val))
        else:
            val = fmt.format(float(val))
        print(f'{k:<{width}}  {val}')
    print(pcolor(bar, 'cyan'))
