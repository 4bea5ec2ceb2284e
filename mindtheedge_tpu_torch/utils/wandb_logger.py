"""Metrics logger: counterpart of ``mindtheedge_tpu/utils/wandb_logger.py``,
its local fallback: metrics buffered and written, one JSON object a line,
to ``metrics.jsonl`` in ``dir``, flushed when a ``global_step`` arrives
(reference ``wandb_logger.py:126-131``).  This process is the one writer.
Uploading to Weights & Biases (``wandb.dry_run: False``) waits for ROADMAP
Queue 1 item 25.
"""

import json
import os
import time


class WandbLogger:
    def __init__(self, name='', dir='', entity='', project='', tags=None,
                 dry_run=True, train_log_step=50, **kwargs):
        if not dry_run:
            raise NotImplementedError(
                'wandb.dry_run False (upload to Weights & Biases) waits for '
                'ROADMAP Queue 1 item 25')
        self.train_log_step = train_log_step
        self._metrics = {}
        os.makedirs(dir or '.', exist_ok=True)
        self._jsonl = open(os.path.join(dir or '.', 'metrics.jsonl'), 'a')

    def log_config(self, config):
        """Nothing to do: the config travels in every checkpoint."""

    def log_metrics(self, metrics, global_step=None):
        self._metrics.update({k: float(v) for k, v in metrics.items()})
        if global_step is not None:
            self._metrics['global_step'] = int(global_step)
            self._flush()

    def _flush(self):
        if self._metrics:
            self._metrics['ts'] = time.time()
            self._jsonl.write(json.dumps(self._metrics) + '\n')
            self._jsonl.flush()
            self._metrics = {}

    def finish(self):
        self._flush()
        self._jsonl.close()
