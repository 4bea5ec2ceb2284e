"""matplotlib's ``Spectral`` colour map without matplotlib.

The inference CLI writes each depth map as a log-depth Spectral colour PNG
(``mindtheedge_tpu/cli/infer_edges.py:136-140``, matplotlib's
``ScalarMappable(Normalize(0, 1), 'Spectral').to_rgba``).  The card's
machine has no matplotlib, so the port keeps its own copy of the map: the
11 ColorBrewer control points of matplotlib's ``_Spectral_data``, expanded
to its 256-entry table by matplotlib's own interpolation
(``colors._create_lookup_table``), and indexed as ``Colormap.__call__``
indexes a float input: ``x * 256`` truncated, 1.0 in the last bin.
"""

import numpy as np

# matplotlib/_cm.py: _Spectral_data
SPECTRAL_DATA = (
    (0.6196078431372549, 0.00392156862745098, 0.25882352941176473),
    (0.8352941176470589, 0.24313725490196078, 0.30980392156862746),
    (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
    (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
    (0.996078431372549, 0.8784313725490196, 0.5450980392156862),
    (1.0, 1.0, 0.7490196078431373),
    (0.9019607843137255, 0.9607843137254902, 0.596078431372549),
    (0.6705882352941176, 0.8666666666666667, 0.6431372549019608),
    (0.4, 0.7607843137254902, 0.6470588235294118),
    (0.19607843137254902, 0.5333333333333333, 0.7411764705882353),
    (0.3686274509803922, 0.30980392156862746, 0.6352941176470588),
)
N = 256     # matplotlib's rcParams['image.lut']


def lookup_table():
    """[N, 3] float64 table, one column per channel, each built as
    ``LinearSegmentedColormap.from_list`` and ``_create_lookup_table`` do."""
    points = np.asarray(SPECTRAL_DATA, dtype=np.float64)
    x = np.linspace(0, 1, len(points)) * (N - 1)
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    columns = [np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1],
                               [y[-1]]]) for y in points.T]
    return np.clip(np.stack(columns, axis=1), 0.0, 1.0)


_TABLE = lookup_table()


def spectral_u8(x):
    """``x`` in [0, 1] (any float dtype, any shape) -> uint8 RGB [..., 3],
    byte-equal to ``(ScalarMappable(Normalize(0, 1), 'Spectral')
    .to_rgba(x)[..., :3] * 255).astype(np.uint8)``.  Values outside [0, 1]
    take the end colours, as matplotlib's under/over colours are the ends;
    NaN is black, matplotlib's 'bad' colour."""
    xa = np.asarray(x) * N          # in x's own dtype: exact, a power of 2
    xa[xa == N] = N - 1
    bad = np.isnan(xa)
    rgb = (_TABLE[np.clip(np.where(bad, 0, xa), 0, N - 1).astype(int)] * 255
           ).astype(np.uint8)
    rgb[bad] = 0
    return rgb
