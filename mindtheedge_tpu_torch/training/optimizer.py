"""Optimizer: Adam over the depth network's trainable parameters, StepLR by
epoch, and the freeze masks.  Counterpart of
``mindtheedge_tpu/training/optimizer.py:17-81`` (reference
``model_wrapper.py:142-180``).

* Adam, or AdamW (decoupled weight decay, as ``optax.adamw``) when
  ``model.optimizer.depth.weight_decay`` is set.
* ``StepLR(step_size, gamma)``, stepped once per epoch by the trainer: the
  JAX package's schedule at ``epoch = step // steps_per_epoch``
  (:func:`steplr`).
* ``freeze_encoder`` / ``freeze_decoder`` / ``freeze_san`` leave those
  parameters out of the optimizer, so they get no update; ``freeze_san``
  also freezes the fusion ``weight`` / ``bias`` (``optimizer.py:38-41``).

A deliberate difference: the JAX package keeps Adam's first moment in
bfloat16 (``mu_dtype=jnp.bfloat16``, ``optimizer.py:60-64``) to fit a 16 GB
TPU; the port keeps both moments in fp32, as the reference's
``torch.optim.Adam`` does.  After one step from zero moments this moves an
update by at most about ``lr * 2**-8``.  The pose network's group is not
ported (ROADMAP Queue 1 item 16).
"""

import torch


def steplr(base_lr, step_size, gamma, steps_per_epoch):
    """The learning rate at a global step (``optimizer.py:17-21``)."""
    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (gamma ** (epoch // step_size))
    return schedule


def is_frozen(name, net):
    """Whether the parameter ``name`` of ``net`` (a ``PackNetSAN``) is
    frozen by its ``freeze_*`` flags."""
    top = name.split('.', 1)[0]
    return (net.freeze_encoder and top == 'encoder'
            or net.freeze_decoder and top == 'decoder'
            or net.freeze_san and top in ('mconvs', 'weight', 'bias'))


def build_optimizer(config, net):
    """(optimizer, scheduler) over ``net``'s trainable parameters."""
    opt_cfg = config.model.optimizer
    sch_cfg = config.model.scheduler
    if opt_cfg.name.lower() != 'adam':
        raise ValueError(f'Unsupported optimizer {opt_cfg.name}')
    if sch_cfg.name != 'StepLR':
        raise ValueError(f'Unsupported scheduler {sch_cfg.name}')
    params = [p for name, p in net.named_parameters() if not is_frozen(name, net)]
    lr, weight_decay = opt_cfg.depth.lr, opt_cfg.depth.weight_decay
    if weight_decay:
        optimizer = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    else:
        optimizer = torch.optim.Adam(params, lr=lr)
    scheduler = torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=sch_cfg.step_size, gamma=sch_cfg.gamma)
    return optimizer, scheduler
