"""Metric reduction across processes and averaging on the host:
counterpart of ``mindtheedge_tpu/utils/reduce.py`` (reference
``utils/reduce.py``).
"""

import numpy as np
import torch
import torch.distributed as dist

from mindtheedge_tpu_torch.parallel.distributed import world_size
from mindtheedge_tpu_torch.utils.depth import DEPTH_METRIC_NAMES


def reduce_value(value, average=True):
    """The sum (or, with ``average``, the mean) of ``value`` over the
    processes, a numpy scalar or array (``reduce.py:14-21``, reference
    ``horovod.py:32-50``); ``value`` unchanged in a single process.  The
    all-reduce runs on the current CUDA device under NCCL, else on the CPU."""
    n = world_size()
    if n == 1:
        return value
    device = (torch.device('cuda', torch.cuda.current_device())
              if dist.get_backend() == 'nccl' else torch.device('cpu'))
    total = torch.tensor(np.asarray(value), device=device)     # a copy: value stays
    dist.all_reduce(total)
    out = (total / n if average else total).cpu().numpy()
    return out[()] if out.ndim == 0 else out


def all_reduce_metrics(metrics_list, dataset_lengths, name='depth'):
    """Average per-sample metrics, each sample counted once however often
    it repeats (reference ``reduce.py:33-82``).

    ``metrics_list``: per dataset, a list of dicts {'idx': [N], <metric>:
    [N, K]} -> per dataset, a dict of averaged [K] metric vectors.
    """
    reduced = []
    for metrics, length in zip(metrics_list, dataset_lengths):
        idx = np.concatenate([np.atleast_1d(m['idx']) for m in metrics])
        out = {}
        keys = [k for k in metrics[0] if k != 'idx']
        for key in keys:
            vals = np.concatenate(
                [np.atleast_2d(np.asarray(m[key])) for m in metrics], axis=0)
            seen = np.zeros(length)
            acc = np.zeros((length, vals.shape[1]))
            for i, sample_idx in enumerate(idx):
                if seen[sample_idx] == 0:      # the first copy of a sample
                    acc[sample_idx] = vals[i]
                seen[sample_idx] = 1
            valid = seen > 0
            out[key] = acc[valid].mean(axis=0) if valid.any() \
                else np.zeros(vals.shape[1])
        reduced.append(out)
    return reduced


def create_dict(metrics, prefixes=('depth', 'depth_pp', 'depth_gt',
                                   'depth_pp_gt'),
                metric_names=DEPTH_METRIC_NAMES):
    """Metric vectors -> named scalars ``<prefix>/<name>`` (reference
    ``reduce.py:119-154``)."""
    out = {}
    for prefix in prefixes:
        if prefix in metrics:
            for name, val in zip(metric_names, np.ravel(metrics[prefix])):
                out[f'{prefix}/{name}'] = float(val)
    return out


def average_loss_and_metrics(batch_outputs, prefix='avg'):
    """Mean 'loss' and mean of each of the 'metrics' over batch outputs
    (reference ``reduce.py:198-222``)."""
    out = {}
    losses = [float(b['loss']) for b in batch_outputs if 'loss' in b]
    if losses:
        out[f'{prefix}-loss'] = float(np.mean(losses))
    keys = set()
    for b in batch_outputs:
        keys.update(b.get('metrics', {}).keys())
    for key in keys:
        vals = [float(b['metrics'][key]) for b in batch_outputs
                if key in b.get('metrics', {})]
        out[f'{prefix}-{key}'] = float(np.mean(vals))
    return out
