"""Model FLOP of the self-supervised training step (PackNet01 + PoseNet),
by ``portbench/flops.py``'s rules: each dense convolution at its shapes,
2 * C_in * C_out * K * (output sites); a training step is the forward
plus, per conv, a data and a weight gradient, with no data gradient into
the input images.

* PackNet01: ``flops.packnet_convs`` at the configuration's widths (the
  SAN-free network is PackNet-SAN's encoder and decoder), the RGB pass.
* PoseNet: its seven stride-2 convs over the target and its contexts
  stacked on channels, and the 1x1 head to 6 numbers a context.

The warps, SSIM, the minimum and the smoothness are not counted: they
are memory-bound elementwise and pooling work, not model FLOP.
"""

from portbench import flops
from portbench.reference.selfsup import POSE_CHANNELS, POSE_KERNELS


def posenet_convs(h, w, contexts=2):
    """[(name, c_in, c_out, kernel elements, output sites, takes the images)]
    of PoseNet's convs (one image)."""
    ins = (3 * (1 + contexts),) + POSE_CHANNELS[:-1]
    convs = []
    for i, (cin, c, k) in enumerate(zip(ins, POSE_CHANNELS, POSE_KERNELS)):
        pad = (k - 1) // 2
        h, w = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
        convs.append((f'conv{i + 1}', cin, c, k * k, h * w, i == 0))
    convs.append(('pose_pred', POSE_CHANNELS[-1], 6 * contexts, 1, h * w, False))
    return convs


def train_flops(convs):
    """Forward and backward FLOP of ``convs`` (one image)."""
    return sum(flops.conv_flops(ci, co, k, s) * (2 if image else 3)
               for _, ci, co, k, s, image in convs)


def selfsup_train_flops(channels, h, w, batch, contexts=2):
    """Model FLOP of one step of a batch of ``batch`` target frames."""
    return batch * (train_flops(flops.packnet_convs(channels, h, w))
                    + train_flops(posenet_convs(h, w, contexts)))
