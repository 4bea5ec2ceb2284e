"""One training step: counterpart of
``mindtheedge_tpu/training/train_step.py`` (reference
``common_trainer.py:93-185``): forward, losses, backward, the gradients'
global norm, the Adam update of the depth and pose networks.
"""

import torch

from mindtheedge_tpu_torch.training.optimizer import build_optimizer
from mindtheedge_tpu_torch.training.state import TrainState


def create_train_state(config, net, epoch=0, step=0, pose_net=None):
    """A train state over ``net`` (and ``pose_net``) with a fresh optimizer
    and scheduler.

    Every parameter gets a zero gradient up front, and each step zeroes it
    in place: parameters that a step's loss does not reach (the SAN ladder
    and the fusion weights where no loss reads the RGBD pass; everything in
    ``SfmModel``) then see a zero gradient, as in JAX, rather than none, so
    Adam(W) updates them as ``optax`` does.
    """
    optimizer, scheduler = build_optimizer(config, net, pose_net)
    state = TrainState(net=net, optimizer=optimizer, scheduler=scheduler,
                       step=step, epoch=epoch, pose_net=pose_net)
    for p in state.parameters():
        p.grad = torch.zeros_like(p)
    return state


def make_train_step(task):
    """``train_step(state, batch, generator, progress=0.0) -> metrics``.

    ``metrics`` holds the task's loss terms and ``grad_norm``, the global L2
    norm of every parameter's gradient, both networks' (``optax.global_norm``),
    as 0-d tensors on the device: nothing waits for the card, so the caller
    averages them once per epoch.  The task's ``train_loss`` drops the
    network's output dict before it returns, so the backward does not run
    beside the graph of an RGBD pass that no loss of the task reads.  A
    loss that reaches no parameter (``SfmModel``) has no backward; the
    gradients stay zero.
    """
    def train_step(state, batch, generator, progress=0.0):
        for net in state.networks():
            net.zero_grad(set_to_none=False)
        loss, metrics = task.train_loss(batch, generator, progress)
        if loss.requires_grad:
            loss.backward()
        metrics['grad_norm'] = torch.nn.utils.get_total_norm(
            [p.grad for p in state.parameters()])
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step
