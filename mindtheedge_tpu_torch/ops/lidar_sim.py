"""LiDAR beam-pattern simulation from dense depth: the port's copy of
``mindtheedge_tpu/ops/lidar_sim.py`` (reference ``utils/tools.py:102-140``,
``LIDARsample``).

Given a dense depth map and the beam geometry, keep the pixels a spinning
LiDAR would hit: in each column the row nearest each vertical beam angle,
then on each beam the pixel nearest each horizontal sample.  It makes
sparse LiDAR input from dense (GTA) ground truth.  Host numpy, data
preparation, not a hot path.
"""

import numpy as np


def lidar_sample(depth, f=960, u0=960, v0=540, lidar_pitch=0.0,
                 lidar_beams=64, lidar_ver_angle=26.8, lidar_hor_res=0.09,
                 max_depth=120.0, fov=90.0):
    depth = np.asarray(depth, dtype=np.float64)
    H, W = depth.shape
    gridx, gridy = np.meshgrid(np.arange(W), np.arange(H))

    x = (gridx - u0) / f * depth
    y = (v0 - gridy) / f * depth
    anglex = np.arctan2(x, np.sqrt(depth ** 2 + y ** 2))
    angley = np.arctan2(y, np.sqrt(depth ** 2 + x ** 2))

    n_hor = int(fov / lidar_hor_res)
    hor_samp = np.linspace(np.deg2rad(-fov / 2), np.deg2rad(fov / 2), n_hor)
    ver_samp = np.linspace(angley.min() + lidar_pitch,
                           angley.min() + np.deg2rad(lidar_ver_angle),
                           lidar_beams)

    # nearest row per beam per column (vectorized over columns)
    # rows_sample[r, c] = beam id + 1 when row r is the beam's hit in column c
    diff = np.abs(angley[:, :, None] - ver_samp[None, None, :])  # [H,W,B]
    best_rows = diff.argmin(axis=0)                              # [W? no: [W,B]] -> axis0 over H
    rows_sample = np.zeros_like(depth)
    cols = np.arange(W)[:, None].repeat(lidar_beams, 1)
    rows_sample[best_rows, cols] = 1 + np.arange(lidar_beams)[None, :]

    lidar_mask = np.zeros_like(depth)
    hor = hor_samp.reshape(1, -1)
    for beam in range(1, 1 + lidar_beams):
        idx = np.where(rows_sample == beam)
        if len(idx[0]) == 0:
            continue
        ax = anglex[idx].reshape(-1, 1)
        nearest = np.abs(ax - hor).argmin(axis=0)
        sel = (idx[0][nearest], idx[1][nearest])
        lidar_mask[sel] = 1

    lidar_mask[depth > max_depth] = 0
    out = np.zeros_like(depth)
    out[lidar_mask == 1] = depth[lidar_mask == 1]
    return out
