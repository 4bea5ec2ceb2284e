"""D3R ordinal depth metric: counterpart of
``mindtheedge_tpu/evaluation/d3r.py:10-36`` (reference ``utils/d3r.py:17-44``).

1 - the mean agreement of the depth-ratio order over random GT point pairs,
with a relative tolerance (3 %, at most 5000 pairs), drawn from
``RandomState(seed)`` as there.
"""

import numpy as np


def d3r_metric(gt, pred, num_pairs=5000, tol=0.03, seed=0):
    """gt, pred: [H,W] metric depth; GT <= 0 is invalid and skipped."""
    gt = np.squeeze(np.asarray(gt))
    pred = np.squeeze(np.asarray(pred))
    ys, xs = np.where(gt > 0)
    n = len(ys)
    if n < 2:
        return 0.0
    rng = np.random.RandomState(seed)
    k = min(num_pairs, n * (n - 1) // 2)
    i1 = rng.randint(0, n, size=k)
    i2 = rng.randint(0, n, size=k)
    keep = i1 != i2
    i1, i2 = i1[keep], i2[keep]

    g1, g2 = gt[ys[i1], xs[i1]], gt[ys[i2], xs[i2]]
    p1, p2 = pred[ys[i1], xs[i1]], pred[ys[i2], xs[i2]]

    def ordinal(a, b):
        ratio = a / np.maximum(b, 1e-12)
        label = np.zeros_like(ratio, dtype=np.int8)
        label[ratio > 1 + tol] = 1
        label[ratio < 1 / (1 + tol)] = -1
        return label

    agree = ordinal(g1, g2) == ordinal(p1, p2)
    return float(1.0 - agree.mean())
