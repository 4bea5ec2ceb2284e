"""Data-parallel training over processes: counterpart of
``mindtheedge_tpu/parallel/mesh.py`` (``make_dp_train_step``, ``:49-98``;
reference ``horovod_trainer.py:53-55``).

The reference's contract is a per-process batch: N processes each compute
the loss over their own ``datasets.train.batch_size`` samples, and the
gradients are averaged by all-reduce.  The JAX package runs it as one
``shard_map`` over a device mesh; here it is ``torch.distributed`` with one
process per GPU, each rank holding a full copy of the networks and the
optimizer.  ``make_dp_train_step(task)`` is the JAX ``base_step``:

* each rank runs the task's full loss and backward on its own batch;
* the gradients are all-reduced to their mean before their norm and the
  update (``make_train_step``'s ``grad_transform``), so every rank takes
  the same Adam step;
* the metrics are all-reduced to their mean;
* after the step, the floating-point buffers (the running statistics of
  the SAN's ``MaskedBatchNorm`` and of any batch norm in training) are
  all-reduced to their mean: the JAX package's sync-BN, a documented
  divergence from Horovod, whose ranks keep their own statistics
  (``mesh.py:59-61``).  They stay fp32 under bf16 compute.  Under remat
  the recompute leaves them alone (``ops/remat.recomputing``), so each
  update is averaged once;
* the first time the step sees a train state, it broadcasts that state's
  parameters and buffers from rank 0, so a seeded start or a resumed
  checkpoint is the same on every rank.

The lr-flip and dropout draws come from the caller's ``torch.Generator``,
seeded alike on every rank, as the JAX step's ``rng`` is replicated
(``in_specs=(P(), P(axis_name), P(), P())``, ``:87``).

Each collective runs on one flat buffer of its tensors (one all-reduce of
the ~111 M gradients a step for the SLIM PackNet-SAN 1A).  It is not
``DistributedDataParallel``: the tasks run the networks through
``torch.func.functional_call`` under bf16 and ``torch.utils.checkpoint``
under remat, both of which bypass or disturb DDP's reducer; parameters that
no loss reaches keep zero gradients on purpose (``train_step.py``), where
DDP would need ``find_unused_parameters``; and DDP's
``broadcast_buffers`` copies rank 0's statistics at each forward, where the
JAX step averages them after it.  Overlapping the all-reduce with the
backward is left for later.

``make_spatial_train_step(task, space)`` is the spatially sharded step of
``mindtheedge_tpu/parallel/spatial.py:210-335``: this step, with the
depth net on this rank's block of the frame.

``make_sharded_train_step(task)`` is the JAX module's
``make_sharded_train_step`` (``mesh.py:101-128``): the plain step on the
*global* batch, its depth net run on this rank's chunk of it, every batch
norm of the depth net (the SAN's and the ResNets') taking the global
batch's statistics, and every per-sample output gathered, so any task of
the registry steps through it.  It differs from ``make_dp_train_step``,
whose ranks each average the loss over their own chunk: the pooled losses
are not linear in the split.
"""

import torch
import torch.distributed as dist

from mindtheedge_tpu_torch.models.resnet import BatchNorm2d
from mindtheedge_tpu_torch.ops.sparse import MaskedBatchNorm
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.parallel.distributed import rank, world_size
from mindtheedge_tpu_torch.training.train_step import make_train_step


def _coalesced(tensors, collective):
    """Run ``collective`` on one flat copy of ``tensors`` (one dtype) and
    copy its result back into them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def _by_dtype(tensors):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def all_reduce_mean(tensors):
    """Average floating-point ``tensors`` over the processes, in place, with
    one all-reduce for each dtype among them."""
    n = world_size()

    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(n)

    for group in _by_dtype(tensors):
        _coalesced(group, mean)


def _float_buffers(state):
    """The floating-point buffers of the state's networks: their running
    statistics."""
    return [b for net in state.networks() for b in net.buffers()
            if b.is_floating_point()]


def broadcast_state(state):
    """Copy rank 0's parameters and buffers to every rank."""
    tensors = state.parameters() + [b for net in state.networks() for b in net.buffers()]
    for group in _by_dtype(tensors):
        _coalesced(group, lambda flat: dist.broadcast(flat, src=0))


def make_dp_train_step(task):
    """``step(state, batch, generator, progress=0.0) -> metrics``: one
    data-parallel step over the process group (see the module's
    docstring); ``batch`` is this rank's share.  The metrics, 0-d tensors on
    the device, are the same on every rank."""
    inner = make_train_step(task, grad_transform=all_reduce_mean)
    broadcast_for = None

    def step(state, batch, generator, progress=0.0):
        nonlocal broadcast_for
        if broadcast_for is not state:
            broadcast_state(state)
            broadcast_for = state
        metrics = inner(state, batch, generator, progress)
        names = sorted(metrics)
        values = torch.stack([metrics[k].detach().float() for k in names])
        all_reduce_mean([values] + _float_buffers(state))
        return dict(zip(names, values.unbind()))

    return step


def make_spatial_train_step(task, space):
    """The H-sharded training step (``parallel/spatial.py:210-335``):
    ``step(state, batch, generator, progress=0.0) -> metrics``, ``batch``
    whole frames of this rank's data replica.

    The depth net runs on this rank's rows (``task.net_input_transform``
    slices ``rgb``, ``input_depth`` and a 4-channel network's ``rgb_edge``
    after the lr-flip; the losses keep the whole ``rgb_edge``, as JAX's
    ``slice_local_h`` does, ``spatial.py:264-275``); its inverse-
    depth pyramids are gathered and ``depth_loss`` averaged over the
    replica's blocks (``task.output_hook``), so every loss runs unchanged
    on full frames, on every rank; the pose net reads the full ``rgb`` the
    rank holds, replicated.  Then :func:`make_dp_train_step`:
    gradients, metrics and running statistics averaged over every rank
    (each block's gradient carries the factor ``n`` of the gather's
    backward, see ``parallel/spatial.py``; space ranks hold equal metrics
    and statistics, so their mean is the data-parallel one).  The lr-flip
    and dropout draws come from the caller's generator, seeded alike on
    every rank.  Only H is sharded in training, as in the JAX package."""
    if space.n_w is not None:
        raise NotImplementedError('the spatial training step shards H only, as the '
                                  'JAX package\'s does')
    spatial.shard_network(task.depth_net, space)
    task.net_input_transform = lambda *inputs: [spatial.shard_spatial(x, space)
                                                for x in inputs]

    def gather_outputs(out):
        out = dict(out)
        for key in ('inv_depths', 'inv_depths_rgbd'):
            if key in out:
                out[key] = [spatial.gather_spatial(d, space) for d in out[key]]
        if 'depth_loss' in out:
            out['depth_loss'] = spatial.space_all_reduce(out['depth_loss'], space, mean=True)
        return out

    task.output_hook = gather_outputs
    return make_dp_train_step(task)


# the depth nets' per-sample outputs, [B,...] tensors or lists of them
_SAMPLE_OUTPUTS = ('inv_depths', 'inv_depths_rgbd', 'ray_surface')


def make_sharded_train_step(task):
    """The plain step on the global batch, the depth net sharded over the
    batch (``mindtheedge_tpu/parallel/mesh.py:101-128``, where XLA runs the
    step jitted with the batch sharded and the state replicated):
    ``step(state, batch, generator, progress=0.0) -> metrics``, ``batch``
    the global batch on every rank, its size a multiple of the world size.

    The depth net runs on this rank's contiguous chunk of the batch
    (``task.net_input_transform``, after the lr-flip); its per-sample
    outputs (the inverse-depth pyramids of both passes, a
    ``RaySurfaceResNet``'s ``ray_surface``) are gathered over the ranks by a
    differentiable tiled all-gather and ``depth_loss`` averaged
    (``task.output_hook``; an output the step does not know raises rather
    than reach the losses as one rank's chunk), so every
    loss runs on the whole batch on every rank; then
    :func:`make_dp_train_step`'s one mean of the gradients (each chunk's
    carries the factor n of the gather's backward, as in
    :func:`make_spatial_train_step`).  Where the plain step could part:

    * every batch norm of the depth net, the SAN's ``MaskedBatchNorm`` and
      the ResNets' ``BatchNorm2d``, takes its training statistics over the
      global batch, as XLA computes them over the sharded batch as one
      (its ``space`` is a ``Space`` of every rank: count, sum and squared
      deviations all-reduced);
    * the dropout masks are drawn for the global batch from the caller's
      generator, seeded alike on every rank, and each rank keeps its
      chunk's (``PackNetSlimEncoder.batch_shard``); the lr-flip is one draw
      for the whole batch.  So the draws are the plain step's.

    The pose net runs on the whole batch on every rank, in eval mode
    (``tasks.BaseTask.run_pose``): its batch norms need no space."""
    n, me = world_size(), rank()
    chunks = spatial.Space(n)       # one block a rank: the batch's chunks
    for m in task.depth_net.modules():
        if isinstance(m, (MaskedBatchNorm, BatchNorm2d)):
            m.space = chunks
        if hasattr(m, 'batch_shard'):
            m.batch_shard = (me, n)

    def chunk(x):
        if x is None:
            return None
        if x.shape[0] % n:
            raise ValueError(f'a global batch of {x.shape[0]} does not split over {n} ranks')
        return x.chunk(n)[me]

    def gather_outputs(out):
        unknown = set(out) - set(_SAMPLE_OUTPUTS) - {'depth_loss'}
        if unknown:
            raise ValueError(f'make_sharded_train_step does not know the depth net\'s '
                             f'outputs {sorted(unknown)}: gather or reduce them over the ranks')
        gather = lambda d: spatial._Gather.apply(d, 0, chunks.block_line)
        out = dict(out)
        for key in _SAMPLE_OUTPUTS:
            if torch.is_tensor(out.get(key)):
                out[key] = gather(out[key])
            elif key in out:
                out[key] = [gather(d) for d in out[key]]
        if 'depth_loss' in out:
            out['depth_loss'] = spatial.space_all_reduce(out['depth_loss'], chunks, mean=True)
        return out

    task.net_input_transform = lambda *inputs: [chunk(x) for x in inputs]
    task.output_hook = gather_outputs
    return make_dp_train_step(task)
