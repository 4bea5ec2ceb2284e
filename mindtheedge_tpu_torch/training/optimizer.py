"""Optimizer: Adam over the trainable parameters, a depth and a pose group,
StepLR by epoch, and the freeze masks.  Counterpart of
``mindtheedge_tpu/training/optimizer.py:17-81`` (reference
``model_wrapper.py:142-180``).

* One parameter group per network: the depth network's at
  ``model.optimizer.depth.lr`` / ``weight_decay``, the pose network's at
  ``model.optimizer.pose.lr`` / ``weight_decay`` (``optimizer.py:64-79``).
* Adam, or AdamW (decoupled weight decay, as ``optax.adamw``) when a
  group's ``weight_decay`` is set; AdamW with a group's decay at 0 is Adam
  for that group.
* ``StepLR(step_size, gamma)``, stepped once per epoch by the trainer: the
  JAX package's schedule at ``epoch = step // steps_per_epoch``
  (:func:`steplr`), for each group.
* ``freeze_encoder`` / ``freeze_decoder`` / ``freeze_san`` leave those
  depth parameters out of the optimizer, so they get no update;
  ``freeze_san`` also freezes the fusion ``weight`` / ``bias``
  (``optimizer.py:38-41``).  They apply to the depth network only.

A deliberate difference: the JAX package keeps Adam's first moment in
bfloat16 (``mu_dtype=jnp.bfloat16``, ``optimizer.py:60-64``) to fit a 16 GB
TPU; the port keeps both moments in fp32, as the reference's
``torch.optim.Adam`` does.  After one step from zero moments this moves an
update by at most about ``lr * 2**-8``.
"""

import torch


def steplr(base_lr, step_size, gamma, steps_per_epoch):
    """The learning rate at a global step (``optimizer.py:17-21``)."""
    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (gamma ** (epoch // step_size))
    return schedule


def is_frozen(name, depth_cfg):
    """Whether the depth network's parameter ``name`` is frozen by the
    ``freeze_*`` flags of ``config.model.depth_net`` (``optimizer.py:24-45``)."""
    top = name.split('.', 1)[0]
    return (depth_cfg.freeze_encoder and top == 'encoder'
            or depth_cfg.freeze_decoder and top == 'decoder'
            or depth_cfg.freeze_san and top in ('mconvs', 'weight', 'bias'))


def build_optimizer(config, net, pose_net=None):
    """(optimizer, scheduler) over ``net``'s trainable parameters (group 0)
    and ``pose_net``'s (group 1) where there is one."""
    opt_cfg = config.model.optimizer
    sch_cfg = config.model.scheduler
    if opt_cfg.name.lower() != 'adam':
        raise ValueError(f'Unsupported optimizer {opt_cfg.name}')
    if sch_cfg.name != 'StepLR':
        raise ValueError(f'Unsupported scheduler {sch_cfg.name}')
    groups = [{'params': [p for name, p in net.named_parameters()
                          if not is_frozen(name, config.model.depth_net)],
               'lr': opt_cfg.depth.lr, 'weight_decay': opt_cfg.depth.weight_decay}]
    if pose_net is not None:
        groups.append({'params': list(pose_net.parameters()),
                       'lr': opt_cfg.pose.lr, 'weight_decay': opt_cfg.pose.weight_decay})
    if any(g['weight_decay'] for g in groups):
        optimizer = torch.optim.AdamW(groups)
    else:
        optimizer = torch.optim.Adam(groups)
    scheduler = torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=sch_cfg.step_size, gamma=sch_cfg.gamma)
    return optimizer, scheduler
