"""Training CLI: counterpart of ``mindtheedge_tpu/cli/train_edges.py``
(reference root ``train_edges.py``).

    python -m mindtheedge_tpu_torch.cli.train_edges <config.yaml|checkpoint.ckpt>

Trains on the card; from Python, ``main(argv, device='cpu')`` runs the
plain PyTorch path on the CPU.  A ``.ckpt`` resumes from that checkpoint;
a yaml whose checkpoint directory already holds checkpoints resumes from
the newest.  The shipped ``configs/train_packnet_san_kitti_with_edges.yaml``
sets ``arch.precision: bfloat16``, which raises until ROADMAP Queue 1
item 9: run it with ``precision: float32``.
"""

import argparse

from mindtheedge_tpu_torch import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Edge-aware depth training')
    parser.add_argument('file', type=str,
                        help='Input file (.yaml config or .ckpt to resume)')
    return parser.parse_args(argv)


def train(file, device=None):
    """Train from ``file`` on ``device`` (``None`` -> CUDA) -> the
    ``Experiment``, its final state in ``.state``."""
    from mindtheedge_tpu_torch.config import parse_train_file
    from mindtheedge_tpu_torch.training.experiment import Experiment
    device = resolve_device(device)
    config, resume_ckpt = parse_train_file(file)
    print(f'Run name: {config.name}; resume: {resume_ckpt}')
    exp = Experiment(config, resume_ckpt=resume_ckpt, device=device)
    exp.fit()
    return exp


def main(argv=None, device=None):
    return train(parse_args(argv).file, device)


if __name__ == '__main__':
    main()
