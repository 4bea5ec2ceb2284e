"""Batched, prefetching data loader: counterpart of
``mindtheedge_tpu/data/loader.py``.  Worker threads read and transform the
samples of a batch; a producer thread collates channel-last numpy batches
``prefetch`` ahead of the consumer.  The training order is a shuffle by
``RandomState(seed + epoch)``, and ``drop_last`` drops a ragged last batch.

Across ``world_size`` processes, rank ``rank`` reads its share:

* with ``drop_last`` (training), the index list is cut into global
  batches of ``batch_size * world_size`` and the rank takes the
  ``rank``-th contiguous ``batch_size`` chunk of each.  These are the
  samples the JAX package's single-host data parallelism gives device
  ``rank`` (a global batch shuffled as above, split by ``shard_batch``,
  ``parallel/mesh.py:39-42``), so a step of the port's data-parallel
  training sees the shards of the JAX step; ``len`` counts global batches,
  the same on every rank, so the ranks meet at every step's all-reduce.
  The reference's ``DistributedSampler`` strides by rank instead: each
  step then holds the same samples split otherwise, and since the pooled
  losses are not linear in the split, its numbers differ;
* without it (validation, test), the indices are strided by rank, as the
  JAX loader does (``loader.py:64-65``); the ranks may then read unequal
  numbers of batches.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BATCH_KEYS_STACK = (
    'rgb', 'rgb_original', 'depth', 'input_depth', 'edge', 'rgb_edge',
    'rgb_edge_for_loss', 'edge_1', 'edge_2', 'edge_3', 'lidar', 'seg',
    'normal', 'normal_1', 'normal_2', 'normal_3', 'intrinsics')


def collate(samples):
    """Stack samples into NHWC numpy batches (fixed shapes after resize)."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in BATCH_KEYS_STACK:
            batch[key] = np.stack(vals)
        elif key in ('rgb_context', 'rgb_context_original', 'depth_context'):
            batch[key] = [np.stack([v[i] for v in vals]) for i in range(len(vals[0]))]
        elif key == 'idx':
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals   # filenames etc. stay lists
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=2,
                 drop_last=False, seed=42, rank=0, world_size=1, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _batches(self):
        """This rank's batches of dataset indices, in order."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        b = self.batch_size
        if self.drop_last:
            step, lo = b * self.world_size, b * self.rank
            return [idx[i + lo:i + lo + b] for i in range(0, len(idx) - step + 1, step)]
        idx = idx[self.rank::self.world_size]
        return [idx[i:i + b] for i in range(0, len(idx), b)]

    def __len__(self):
        return len(self._batches())

    def __iter__(self):
        batches = self._batches()

        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            break
                        q.put(collate(list(pool.map(self.dataset.__getitem__, b))))
            except Exception as e:      # handed to the consumer, raised there
                q.put(e)
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            while t.is_alive():     # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
