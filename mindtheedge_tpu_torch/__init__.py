"""MindTheEdge in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of ``mindtheedge_tpu`` that mirrors its module names: each module here
names the JAX module it re-implements.  Internally the port works in NCHW;
the public entry points (``models.packnet.PackNetSAN.forward`` and
``serve``) keep the JAX package's NHWC layout.  The port imports neither
``jax`` nor ``mindtheedge_tpu``.

Entry points run on the card: ``device=None`` means CUDA, and raises when no
CUDA device is present.  Pass ``device='cpu'`` to run the plain PyTorch
versions on the CPU.
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda`` (raises without a CUDA device); else ``torch.device(device)``."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run on the CPU')
    return device
