"""Batched, prefetching data loader: counterpart of
``mindtheedge_tpu/data/loader.py``.  Worker threads read and transform the
samples of a batch; a producer thread collates channel-last numpy batches
``prefetch`` ahead of the consumer.  The training order is a shuffle by
``RandomState(seed + epoch)``, and ``drop_last`` drops a ragged last batch.
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
                 drop_last=False, seed=42, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

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
