"""Metrics logger: counterpart of ``mindtheedge_tpu/utils/wandb_logger.py``
(reference ``loggers/wandb_logger.py``).  Metrics are buffered and flushed
when a ``global_step`` arrives (reference ``wandb_logger.py:126-131``): to
a Weights & Biases run with ``wandb.dry_run: False`` where ``wandb`` can
be imported and its run starts, else, one JSON object a line, to
``metrics.jsonl`` in ``dir``.  Rank 0 is the one writer (``wandb_logger.py:24``,
the reference's ``@on_rank_0``): on the other ranks the logger opens,
creates and sends nothing.
"""

import json
import os
import time

from mindtheedge_tpu_torch.parallel.distributed import is_main_process


class WandbLogger:
    def __init__(self, name='', dir='', entity='', project='', tags=None,
                 dry_run=True, train_log_step=50, **kwargs):
        self.train_log_step = train_log_step
        self._metrics = {}
        self._jsonl = self._wandb = None
        self.is_writer = is_main_process()
        if not self.is_writer:
            return
        if not dry_run:
            self._wandb = self._start_run(name=name or None, dir=dir or None,
                                          entity=entity or None,
                                          project=project or None, tags=tags or [])
        if self._wandb is None:
            os.makedirs(dir or '.', exist_ok=True)
            self._jsonl = open(os.path.join(dir or '.', 'metrics.jsonl'), 'a')

    @staticmethod
    def _start_run(**kwargs):
        """The ``wandb`` module with a run started, or None (printed) where
        it is absent or its run does not start: training goes on."""
        try:
            import wandb
        except ImportError:
            print('wandb is not installed: metrics go to metrics.jsonl')
            return None
        try:
            wandb.init(**kwargs)
        except Exception as e:      # no login, no network: the run goes on
            print(f'wandb.init failed ({type(e).__name__}: {e}): metrics go to '
                  'metrics.jsonl')
            return None
        return wandb

    def log_config(self, config):
        """The run's config to Weights & Biases; the JSONL file needs none,
        the config travels in every checkpoint."""
        if self._wandb is not None:
            self._wandb.config.update(config.to_dict(), allow_val_change=True)

    def log_metrics(self, metrics, global_step=None):
        if not self.is_writer:
            return
        self._metrics.update({k: float(v) for k, v in metrics.items()})
        if global_step is not None:
            self._metrics['global_step'] = int(global_step)
            self._flush()

    def _flush(self):
        if not self._metrics:
            return
        if self._wandb is not None:
            self._wandb.log(self._metrics)
        else:
            self._metrics['ts'] = time.time()
            self._jsonl.write(json.dumps(self._metrics) + '\n')
            self._jsonl.flush()
        self._metrics = {}

    def finish(self):
        if not self.is_writer:
            return
        self._flush()
        if self._wandb is not None:
            self._wandb.finish()
        else:
            self._jsonl.close()
