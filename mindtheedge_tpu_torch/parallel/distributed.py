"""Multi-process start-up: counterpart of
``mindtheedge_tpu/parallel/distributed.py`` (reference
``utils/horovod.py:22-44``, ``horovod.init()`` and ``rank() == 0``).

One process per GPU, as ``torchrun`` launches them::

    torchrun --nproc_per_node N -m mindtheedge_tpu_torch.cli.train_edges <config.yaml>

``maybe_initialize_distributed(device)`` is called first by every CLI.  It
starts ``torch.distributed`` only when a launcher's variables ask for it
(``torchrun --nproc_per_node 1`` too), and keeps the JAX module's rules:

* no launcher variable: a no-op that touches no network (a plain run, the
  tests);
* ``MTE_DISTRIBUTED=0`` disables it; ``MTE_DISTRIBUTED=1`` forces it, and
  the launcher's variables must then be there;
* an explicit launch (``MASTER_ADDR`` set, as ``torchrun`` sets it) needs
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; rank, world
  size and local rank may instead come from Slurm (``SLURM_PROCID``,
  ``SLURM_NTASKS``, ``SLURM_LOCALID``) or Open MPI
  (``OMPI_COMM_WORLD_RANK`` / ``_SIZE`` / ``_LOCAL_RANK``).  A variable
  missing raises, naming it: an explicit launch never runs alone;
* Slurm or Open MPI markers without ``MASTER_ADDR`` cannot meet (torch has
  no address to rendezvous at): a line says so and the run stays
  single-process, as the JAX module does where its auto-config fails;
* a process group that already exists is reused (``chip_smoke.py`` and the
  tests make their own).

The device is the caller's ``device`` where it gives one (so two ranks can
share one card, over gloo), else ``cuda:LOCAL_RANK``, which must exist:
a local rank at or past ``torch.cuda.device_count()`` raises, it never
wraps or falls back to the CPU.  The backend is NCCL on a CUDA device and
gloo on the CPU.  A group started here is destroyed at the process's exit.
"""

import atexit
import os

import torch
import torch.distributed as dist

# a cluster's marker -> its variables for RANK, WORLD_SIZE and LOCAL_RANK
_CLUSTERS = {
    'SLURM_JOB_ID': ('SLURM_PROCID', 'SLURM_NTASKS', 'SLURM_LOCALID'),
    'OMPI_COMM_WORLD_SIZE': ('OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE',
                             'OMPI_COMM_WORLD_LOCAL_RANK'),
}
_LAUNCH_VARS = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK')


def _launch_values(cluster):
    """The explicit launch's variables, each from torchrun's name or else
    from the cluster's -> {name: value}; raises naming the missing ones."""
    fallback = dict(zip(('RANK', 'WORLD_SIZE', 'LOCAL_RANK'), _CLUSTERS.get(cluster, ())))
    values, missing = {}, []
    for name in _LAUNCH_VARS:
        value = os.environ.get(name, os.environ.get(fallback.get(name, ''), ''))
        if value:
            values[name] = value
        else:
            missing.append(name)
    if missing:
        raise RuntimeError(
            f'a multi-process launch needs {", ".join(_LAUNCH_VARS)}, and '
            f'{" and ".join(missing)} {"is" if len(missing) == 1 else "are"} missing: '
            'launch with torchrun --nproc_per_node N, or set them, or unset '
            'MASTER_ADDR and MTE_DISTRIBUTED to run single-process')
    return values


def _device(device, local_rank):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" to run '
                           'the ranks on the CPU over gloo')
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f'LOCAL_RANK {local_rank}, but this node has '
            f'{torch.cuda.device_count()} CUDA device(s): launch at most one '
            'process per device')
    return torch.device('cuda', local_rank)


def _shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def maybe_initialize_distributed(device=None):
    """Start ``torch.distributed`` iff a launcher asks for it (see the
    module's docstring) -> whether a process group exists."""
    if dist.is_initialized():
        return True
    flag = os.environ.get('MTE_DISTRIBUTED', '').strip().lower()
    if flag in ('0', 'false', 'off'):
        return False
    cluster = next((m for m in _CLUSTERS if m in os.environ), None)
    if 'MASTER_ADDR' not in os.environ and flag not in ('1', 'true', 'on'):
        if cluster is not None:
            print(f'Distributed: {cluster} is set but MASTER_ADDR is not, so the '
                  'processes have no address to meet at; running single-process')
        return False
    values = _launch_values(cluster)
    rank_, world = int(values['RANK']), int(values['WORLD_SIZE'])
    device = _device(device, int(values['LOCAL_RANK']))
    if device.type == 'cuda' and device.index is not None:
        torch.cuda.set_device(device)
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
    # env:// reads MASTER_ADDR and MASTER_PORT, which have no cluster names
    dist.init_process_group(backend, init_method='env://', rank=rank_, world_size=world)
    atexit.register(_shutdown)
    print(f'Distributed: process {rank_} of {world}, backend {backend}, device {device}')
    return True


def rank():
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process():
    """The rank-0 gate of the writers (reference ``horovod.py:38-44``)."""
    return rank() == 0


def barrier():
    """Wait for every rank; nothing without a process group."""
    if dist.is_initialized():
        dist.barrier()
