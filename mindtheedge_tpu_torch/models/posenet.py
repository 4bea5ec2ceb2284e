"""PoseNet: counterpart of ``mindtheedge_tpu/models/posenet.py:16-45``
(reference ``networks/pose/PoseNet.py:39-85``).

Seven stride-2 conv + GroupNorm(16) + ReLU layers (kernels 7, 5, 3, 3, 3,
3, 3; widths 16 to 256) over the target image and its context images
stacked on channels, a 1x1 head to 6 numbers per context image, the
spatial mean, times 0.01.  ``state_dict`` keys are the reference's:
``conv{i}.0`` (conv), ``conv{i}.1`` (GroupNorm), ``pose_pred``.
"""

import torch
import torch.nn as nn

CHANNELS = (16, 32, 64, 128, 256, 256, 256)
KERNELS = (7, 5, 3, 3, 3, 3, 3)


class PoseNet(nn.Module):
    def __init__(self, nb_ref_imgs=2):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        ins = (3 * (1 + nb_ref_imgs),) + CHANNELS[:-1]
        for i, (cin, c, k) in enumerate(zip(ins, CHANNELS, KERNELS)):
            self.add_module(f'conv{i + 1}', nn.Sequential(
                nn.Conv2d(cin, c, k, stride=2, padding=(k - 1) // 2),
                nn.GroupNorm(16, c), nn.ReLU()))
        self.pose_pred = nn.Conv2d(CHANNELS[-1], 6 * nb_ref_imgs, 1)

    def forward(self, image, context):
        """image [B,H,W,3], context: ``nb_ref_imgs`` [B,H,W,3] -> [B,n,6]."""
        if len(context) != self.nb_ref_imgs:
            raise ValueError(f'PoseNet takes {self.nb_ref_imgs} context images, '
                             f'got {len(context)}')
        x = torch.cat([image] + list(context), -1).permute(0, 3, 1, 2)
        for i in range(len(CHANNELS)):
            x = getattr(self, f'conv{i + 1}')(x)
        pose = self.pose_pred(x).mean((2, 3))
        return 0.01 * pose.reshape(pose.shape[0], self.nb_ref_imgs, 6)
