"""Train state: counterpart of ``mindtheedge_tpu/training/state.py``.  The
JAX package threads a functional pytree through a compiled step; here the
networks, optimizer and scheduler are stateful objects, held together with
the step and epoch counters."""

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainState:
    net: Any            # the depth network (nn.Module), its running stats inside
    optimizer: Any      # torch.optim.Adam / AdamW, a depth and a pose group
    scheduler: Any      # torch.optim.lr_scheduler.StepLR, stepped per epoch
    step: int = 0       # global step: optimizer updates so far
    epoch: int = 0      # the epoch to run next
    pose_net: Any = None    # the pose network of the self-supervised tasks

    def networks(self):
        """The depth network, then the pose network where there is one."""
        return [n for n in (self.net, self.pose_net) if n is not None]

    def parameters(self):
        return [p for n in self.networks() for p in n.parameters()]
