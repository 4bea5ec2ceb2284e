"""Training CLI: counterpart of ``mindtheedge_tpu/cli/train_edges.py``
(reference root ``train_edges.py``).

    python -m mindtheedge_tpu_torch.cli.train_edges <config.yaml|checkpoint.ckpt>
    torchrun --nproc_per_node N -m mindtheedge_tpu_torch.cli.train_edges <config.yaml>

Trains on the card, or data-parallel on N cards under ``torchrun``
(``parallel/distributed.maybe_initialize_distributed`` first, as
``train_edges.py:17-18``; ``datasets.train.batch_size`` per card); from
Python, ``main(argv, device='cpu')`` runs the plain PyTorch path on the
CPU.  A ``.ckpt`` resumes from that checkpoint;
a yaml whose checkpoint directory already holds checkpoints resumes from
the newest.  The shipped ``configs/train_packnet_san_kitti_with_edges.yaml``
trains as written, in bf16 (``arch.precision: bfloat16``: the depth
network computes in bf16 on fp32 master weights); its other documented
form, ``precision: float32`` with ``model.depth_net.remat: True``, runs
too.  The checkpoints hold fp32 tensors either way, so a run in one
precision resumes in the other.
"""

import argparse

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.parallel.distributed import (
    is_main_process, maybe_initialize_distributed)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Edge-aware depth training')
    parser.add_argument('file', type=str,
                        help='Input file (.yaml config or .ckpt to resume)')
    return parser.parse_args(argv)


def train(file, device=None):
    """Train from ``file`` on ``device`` (``None`` -> CUDA, the launcher's
    local rank's card under ``torchrun``) -> the ``Experiment``, its final
    state in ``.state``."""
    from mindtheedge_tpu_torch.config import parse_train_file
    from mindtheedge_tpu_torch.training.experiment import Experiment
    maybe_initialize_distributed(device)
    device = resolve_device(device)
    config, resume_ckpt = parse_train_file(file)
    if is_main_process():
        print(f'Run name: {config.name}; resume: {resume_ckpt}')
    exp = Experiment(config, resume_ckpt=resume_ckpt, device=device)
    exp.fit()
    return exp


def main(argv=None, device=None):
    return train(parse_args(argv).file, device)


if __name__ == '__main__':
    main()
