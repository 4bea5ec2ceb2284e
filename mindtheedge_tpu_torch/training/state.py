"""Train state: counterpart of ``mindtheedge_tpu/training/state.py``.  The
JAX package threads a functional pytree through a compiled step; here the
network, optimizer and scheduler are stateful objects, held together with
the step and epoch counters."""

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    net: Any            # the depth network (nn.Module), its SAN running stats inside
    optimizer: Any      # torch.optim.Adam / AdamW
    scheduler: Any      # torch.optim.lr_scheduler.StepLR, stepped per epoch
    step: int = 0       # global step: optimizer updates so far
    epoch: int = 0      # the epoch to run next
