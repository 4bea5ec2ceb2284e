"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root, on a machine with one CUDA card and nvcc.

1. Build every CUDA kernel of the path from ``mindtheedge_tpu_torch/csrc``
   (nvcc, sm_90a) into ``build/kernels/``.
2. Hold the Sobel-5 + NMS kernel against its plain PyTorch version on the
   card: uniform noise [4,384,1280], Gaussian-smoothed noise x4, the DEE
   annotation scales, odd shapes (W % 4 != 0, H below one band), an input
   that is not 16-byte aligned and the exact-dyadic zero-gradient patch.
   >= 99.99 % of pixels agree, every pixel of the patch, and kept values
   are bit-equal.
3. Run a small PackNet-SAN 1A (channels (16,)*6, 64x96, batch 2, LiDAR) on
   the card and on the CPU with the same weights, both built by
   ``serve.build``: all 4 scales at rtol 1e-4, atol 1e-5 (fp32, TF32 off,
   as ``models.packnet.to_device`` sets it; no phase sets a backend flag
   of its own but the spawned ranks of 11-12, whose autotuner times fewer
   candidates).
   Then ``annotate_batch`` of the DEE path, card vs CPU on the same
   network and inputs: edge maps within 1e-4 on >= 99.9 % of pixels per
   scale,
   normals within one code on >= 99.9 %, hysteresis bit-equal.
4. Serve full-width PackNet-SAN 1A (SLIM channels, 384x1280, batch 4, fp32,
   95 %-sparse LiDAR) built by ``serve.build``: 2 warm-up requests (the
   first one runs cuDNN's autotuner) and 5 timed ones through
   ``serve.serve``, rgb and LiDAR perturbed on every request; the NMS
   kernel must launch once per request.  Then time the kernel: at
   [4,384,1280] on 8 inputs in turn (more than L2) by CUDA events, and by
   ``torch.profiler`` over the same kind of run; on the served map, warm in
   L2 as on the main path; at the DEE scales; and its plain version.
   Then the pack layers' 3-D conv kernel (``csrc/conv3d_kernel.cu``) at the
   ten [4,D,H,W] shapes of a batch-4 request, fp32 and bf16, against
   ``F.conv3d`` on the same inputs at the card tests' tolerances
   (``tests/test_torch_conv3d_kernel_cuda.py``), and a request's ten convs
   timed by CUDA events, kernel and ``F.conv3d``, beside their bound.
   The same bf16 convs again on channels-last inputs (the NHWC layout of
   the bf16 networks, output channels-last), checked and timed alike, each
   shape timed alone in both bf16 layouts.
   Phases 4 and 10a hold the kernel to 10 launches a request, 7b and 10d
   to 20 a training step (both passes).
   Then the GroupNorm + ELU kernel pair (``csrc/gn_elu_kernel.cu``,
   ``GroupNormEluFn``) at every GroupNorm shape of PackNet01 FULL and SLIM
   at [3,384,1280] and at [2,37,101] x 6 widths against fp64 and the plain
   version at the card test's tolerances
   (``tests/test_torch_gn_elu_kernel_cuda.py``); the 47 of a FULL pass
   timed by CUDA events, forward and backward, beside their bound (6 and
   14 bytes an element) and ATen's plain version on the same input.  Every
   serving, annotation, inference and training path holds the pair to 47
   launches a network pass (4.7 a 3-D conv launch) in bf16 and 0 in fp32;
   phases 4, 7b, 8c, 13c and the sharded bf16 jobs of 12b-c to 0.
   Then the warp's geometry kernel pair (``csrc/warp_kernel.cu``), forward
   and backward, against autograd of the plain chain
   (``project(reconstruct(...))``) on the same inputs at the four scales
   of [3,384,1280] and a ragged [2,37,101], at the card tests' tolerances
   (``tests/test_torch_warp_kernel_cuda.py``); each pass at [3,384,1280]
   timed by CUDA events beside its bytes bound, the Function's forward +
   backward as the host drives it, and the plain chain.  Every training
   phase holds the warp kernel to its launches a step: 8 (2 contexts x 4
   scales) in 8c and 13c, 0 in the others; serving, annotation and
   inference (4-6, 10a-c) launch it 0 times.
5. The DEE annotation path at full width (``EdgeEstimationLIDARModel``, the
   same network, LiDAR /200): 2 warm-up and 5 timed batches through
   ``cli.infer_edge_estimation.annotate_batch`` (forward, then at each of
   the 4 scales normals, the NMS kernel and hysteresis), uploads and
   read-backs included; the NMS kernel must launch 4 times per batch.
   Each scale's NMS map is held against the plain version, and hysteresis
   on the card against hysteresis on the CPU, bit for bit.  Prints ms per
   batch, hysteresis iterations, checks and their cost per scale, host
   syncs per batch, peak memory, the kernel's time at the 4 shapes and
   the time of each stage alone.
6. The batch-inference path at full width (``SemiSupEdgeModel``, the same
   network): 2 warm-up and 5 timed batches through
   ``cli.infer_edges.infer_batch`` with the sparse uint16 LiDAR uplink and
   the uint16 depth downlink, uploaded and read back by the CLI's pinned
   helpers with no host sync (torch's sync debug mode, a prototype that
   does not see every sync, raises on the ones it sees);
   depth finite and >= 0.5 m, and the uint16 codes within one code of the
   dense float32 uplink's.
7. Training (``SemiSupEdgeModel``; the NMS kernel lies off this path and
   must launch 0 times; the 3-D conv kernel runs in both passes).
   a. One ``train_step`` at [2,64,96], channels (16,)*6, dropout 0,
      ``flip_lr_prob`` 0, on the card and on the CPU from the same weights
      and batch (``tests/test_torch_train_cuda.py``): loss rtol 1e-4,
      gradients within 1e-4 of each tensor's largest, parameters after the
      Adam step within lr * 1e-2, SAN running statistics rtol 1e-4.
   b. Full width: the task of ``configs/train_packnet_san_kitti_with_edges.yaml``
      with ``arch.precision`` float32 (dropout 0.5, ``flip_lr_prob`` 0.5,
      edge weight 10, GradLoss at 4 scales with normals, sparse-silog, Adam
      lr 1e-4), random weights from its seed, one seeded synthetic batch
      made on the card (batch 3, 384x1280, a blocky depth scene, LiDAR 95 %
      sparse, GT 75 % sparse, edges and normals at the 4 scales): 2 warm-up
      steps (cuDNN's autotuner), 5 timed by CUDA events, then the
      forward, the loss, the backward and the optimizer each timed alone.
      Fails on a non-finite loss or gradient norm, or if no parameter or
      SAN running statistic moved.
   c. The entry point: a 4-frame synthetic GTA split at 384x1280 written to
      ``build/train_smoke/`` (the 8-column format), ``cli.train_edges.main``
      for 1 epoch at batch 2 with the shipped augmentations and validation
      on 2 frames; the checkpoint reloads bit-equal and a resume from it
      starts at epoch 1 with the optimizer's step count restored.
8. The rest of the training family (the NMS kernel must launch 0 times in
   each).
   a. One ``train_step`` card vs CPU at [2,64,96], channels (16,)*6, as 7a,
      of ``EdgeEstimationLIDARModel`` (DEE), ``SemiSupEdgeCompletionModel``
      and ``SemiSupModel`` at ``supervised_loss_weight`` 0.5 with
      ``PoseNet`` and one back and one forward context image
      (``tests/test_torch_train_cuda.py``); and the photometric loss, card
      vs CPU, its value and its gradients.
   b. DEE training at full width: ``EdgeEstimationLIDARModel`` on the
      network and batch of 7b (LiDAR on, so both passes feed the loss; all
      4 edge scales): 2 warm-up steps, 5 timed, the parts timed alone,
      peak memory.
   c. Self-supervised training at full width: the shipped training config
      at ``supervised_loss_weight`` 0.9 with ``PoseNet``, one back and one
      forward context, batch 3, 384x1280; 7b's batch plus two context
      frames (the scene shifted by 4 and -4 pixels), their originals and
      KITTI intrinsics: as 8b, and the pose network and the photometric
      loss each timed alone.
   d. The entry point on KITTI: a 6-frame synthetic KITTI raw tree at
      96x320 written to ``build/train_smoke_kitti/`` by
      ``tests/test_torch_train_cuda.write_kitti_tree``, then
      ``cli.train_edges.main`` for 1 epoch of ``SemiSupModel`` with
      ``PoseNet`` at batch 2 through
      ``KITTIDataset`` (4 frames with both context frames) and validation;
      the checkpoint holds the pose network and reloads bit-equal.
9. The KITTI-DE evaluation end to end: a synthetic tree of 56 frames (about
   half of KITTI-DE's 115-frame split: cut from 115 when phase 13 joined,
   from 60 when the 3-D conv phase joined)
   at KITTI's 375x1242 written to ``build/eval_smoke/`` by ``write_split`` (RGB, uint16 GT depth, GT edges,
   LiDAR), then ``python -m mindtheedge_tpu_torch.cli.infer_edges`` with
   ``configs/infer_packnet_kitti.yaml`` (only its split, GT lists and output
   folder replaced: inference at 384x1280, batch 4, u16 wire, then the
   depth metrics, D3R and the edge AUC over 12 Canny thresholds) in a fresh
   process; the NMS kernel must launch 0 times there.  Fails unless the CLI
   exits 0 having written 56 depth maps and colour PNGs, finite mean depth
   metrics and both AUCs in [0, 1], with the g++-built native matcher.
   Prints the wall seconds and frames/s of inference, of the depth metrics
   and D3R, and of the edge AUC, the AUCs and the mean depth metrics.
10. bf16 and activation recomputation, each bf16 phase on the weights and
   inputs of its fp32 counterpart, its error printed beside its time.
   a. Serving in bf16 (``serve.build(dtype=torch.bfloat16)``): phase 4's
      requests, 2 warm-up and 10 timed; the NMS kernel launches once per
      request, on the f32 map cast after the network, and agrees with its
      plain version there; the depth's relative error against fp32
      (median, p99, max) and the share of edge pixels that agree.
   b. Annotation with ``configs/annotate_edges_kitti_training_set.yaml``
      plus ``precision: bfloat16`` (4 launches a batch); the edge
      agreement against fp32 at each scale.
   c. Inference in bf16 (phase 6's path, no NMS launch); the depth's error.
   d. The shipped training yaml as written (bf16) on 7b's batch, weights
      and generator seed: ms per step, peak, the parts, and the loss of
      every step beside 7b's.
   e. 7b's config with ``remat`` True, then ``'conv'``: ms per step and
      peak against 7b's; one step of each against the step without remat
      from the same weights and generator: the same dropout draws and
      statistics counts, loss, gradients and running statistics within
      4x the card's run-to-run noise, or 1e-4 (7a's tolerance).
   f. At [2,64,96], (16,)*6: one bf16 ``train_step`` card vs CPU within 2x
      the CPU's own bf16-vs-fp32 gap, and remat vs none on the card with
      dropout and flip on (``tests/test_torch_train_cuda.py``).
   No NMS launch on the training phases.
11. Data parallelism across processes (``parallel/``; the NMS kernel must
   launch 0 times on these paths).
   a. NCCL at world size 1 (a ``file://`` store): one step's loss,
      gradients and running statistics against the plain step from the
      same weights, within 4x the card's noise of two plain steps (at least
      1e-4, 7a's tolerance), as 10e; then 7b's config, batch and seed
      through ``make_dp_train_step``, 2 warm-up and 5 timed steps: ms per
      step, peak, and the loss of every step within ``RUN_RTOL`` of 7b's,
      beside a second plain run's gap to 7b (the card's nondeterministic
      reductions part runs of the same arithmetic by up to ~4e-3 in 7
      steps); one all-reduce of gradients shaped like the network's alone,
      by CUDA events.
   b. Two spawned ranks over gloo on the one card (``device='cuda:0'``
      each; ``tests/test_torch_dp_cuda.oracle_job``; the pair of ranks of
      12b and 12c, whose jobs run after it): one data-parallel
      step at [2 per rank, 64, 96], (16,)*6, against rank 0's oracle (the
      mean of the two ranks' plain steps on the card) within 7a's
      tolerances, both ranks' parameters bit-equal; then 3 full-width steps
      of 7b's config a rank after one warm-up, ms and peak per rank, and
      one all-reduce alone: gloo reduces the card's tensors through the
      host, so these are no speed figure for NCCL.
   c. ``python -m torch.distributed.run --standalone --nproc_per_node 1``
      (beside d's launcher, both at once) of ``cli.train_edges`` on 7c's
      split resized to 96x320, 1 epoch
      without validation (a fresh process autotunes every conv shape,
      about a minute at full width): the group comes up (NCCL, world 1),
      the checkpoint and ``metrics.jsonl`` are written.
   d. ``cli.infer_edges --dp 1 --wire u16`` under the same launcher on the
      first 8 frames of phase 9's split: every depth within one u16 code
      of phase 9's files (both fresh processes, same weights; cuDNN's
      autotuner may pick other algorithms, so not byte-equal).
   e. ``make_sharded_train_step`` in the pair of ranks of 11b (job
      ``tests/test_torch_dp_cuda.sharded_step_job``): 7b's config with
      ``flip_lr_prob`` 0, a global batch of 4 at 384x1280 (2 a rank), one
      step against the plain card step on the global batch from the same
      weights and generator (12b's bounds), then 3 timed steps: ms and
      peak a rank.
   f. ``make_sharded_train_step`` on a ResNet in the same pair: 13d's
      ``GenericSelfSupModel`` (``RaySurfaceResNet`` 18 + ``PoseNet``) at a
      global batch of 2 (1 a rank, so each ``BatchNorm2d`` must take the
      global batch's statistics) at 384x1280, one step against the plain
      card step on the global batch taken in this process from the same
      weights and generator: loss rtol 1e-4, the running statistics rtol
      1e-4, each network's gradients by relative L2 within
      ``GENERIC_SHARDED_L2`` (the step is ill-conditioned in fp32, ROADMAP
      L4), both ranks' parameters and statistics bit-equal; then 2 timed
      steps: ms and peak a rank.

12. Spatial sharding with halo exchange (``parallel/spatial.py``; the NMS
   kernel must launch 0 times on these paths, and the sharded 3-D convs
   are ``F.conv3d``).
   a. NCCL at world size 1: phase 4's network and last request (SLIM,
      384x1280, batch 4, 95 %-sparse LiDAR) through ``make_spatial_infer``
      with a space of one (zero-pad exchanges, the gathered GroupNorm
      statistics) against ``serve.build``'s unsharded forward: 4 scales
      within rtol 1e-4, atol 1e-5; ms of each, by CUDA events, in turn.
   b. Two spawned ranks over gloo sharing the card (NCCL refuses two ranks
      on one GPU), H over 2 (``tests/test_torch_spatial_cuda.card_pair_job``;
      its card test holds the same at [2,128,96] and [2,128,64]): 12a's
      full-width forward (rtol 1e-4, atol 1e-5), its ms a rank and the
      collectives of one forward, one halo exchange alone; then one
      ``make_spatial_train_step`` step of 7b's config with ``flip_lr_prob``
      0 (batch 3, 384x1280, fp32) against the plain card step from the same
      weights, batch and generator (loss rtol 1e-5, every gradient within
      1e-4 of its tensor's largest, running statistics rtol 1e-4), and 3
      timed steps: ms per step and peak memory per rank.  Then the same in
      bf16 (``serve.build(dtype=torch.bfloat16)``, the config at
      ``arch.precision: bfloat16``) against the unsharded bf16 forward and
      step on the card: the inverse depths' relative error (median, max),
      the loss and each gradient and running-statistics tensor's worst
      error over its largest (median, max over the tensors) within
      ``BAND`` (2) times the card's own bf16-vs-fp32 gap on the same
      inputs.  The ranks first report which gloo collectives take bf16
      tensors on the card.
   c. ``cli.infer_edges --spatial 2 --wire f32`` in the same two ranks
      (``main(argv, device='cuda:0')``) on 2 synthetic frames at DDAD-DE's
      1216x1936 with ``configs/eval_ddad_de.yaml``'s model block, its
      split and output folder replaced and the frames resized to 1216x1920
      (5 pack levels need a multiple of 32; 1936 is not): every depth map
      within rtol 1e-4, atol 1e-5 of the unsharded CLI's on the card;
      wall seconds of both.  Then the same at ``arch.precision:
      bfloat16``: the depth's relative error against the unsharded bf16
      CLI within ``BAND`` times that CLI's own bf16-vs-fp32 gap.
   13a's L4 check (first, in both fresh ranks), 11b, 11e, 11f, 12b and
   12c run as jobs of one pair of spawned ranks (one ``start_ranks``
   call), each job counting its own NMS launches; cuDNN's autotuner there
   times 3 candidates a conv (``PAIR_CUDNN_LIMIT``).  The unsharded CLIs
   of 12c run first in this process, the other oracles while the ranks
   start.
13. The depth networks and tasks beside PackNet-SAN 1A
   (``tests/test_torch_variants_cuda.py``; the NMS kernel must launch 0
   times on these paths).
   a. At [2,64,96], (16,)*6, card vs CPU from the same weights: the eval
      forward of the 4-channel PackNet-SAN 1A with LiDAR, PackNet-SAN 1B,
      ``PackNet01`` 1A and 1B (4 scales, rtol 1e-4, atol 1e-5); one
      ``train_step`` of ``SelfSupModel`` + ``PoseNet`` on ``PackNet01``
      (8a's bounds) and of ``GenericSelfSupModel`` (``RaySurfaceResNet`` 18
      + ``PoseNet``) at progress 0.5 (loss and metrics rtol 1e-4; the
      generic camera's patch logits card vs CPU within 1e-5, its warp on
      pinhole rays against fp64 within 1e-3 of each gradient's largest; each
      network's backward from seeded cotangents within 8a's gradient
      bound; the step's own gradients printed, not held: they are
      ill-conditioned in fp32 on any device, near-ties of the soft argmax
      and coordinates on pixel centres, where the sampler's derivative
      jumps, part two devices' roundings).
      The step's gradients are also printed against the CPU's fp64 ones,
      and a second card step against the first (ROADMAP L4), and held
      within ``GENERIC_STEP_BAND`` times the CPU's own fp32 gap; the same
      check runs in each of the pair's two fresh ranks (phase 11-12), so
      three processes a run, each printing its ratio.
      Then ROADMAP L2: the seeded (16,)*6 network on blocky frames
      [4,128,128], ``F.group_norm`` and the two-pass statistics each
      against fp64 on the card.
   b. ``cli.infer_edges --wire f32`` in a fresh process on 8 synthetic
      KITTI-size frames with a .npy ``rgb_edge`` column, the SLIM
      PackNet-SAN 1A with ``input_channels: 4`` and LiDAR, written to
      ``build/variants_smoke/``: every depth map within rtol 1e-4, atol
      1e-5 of the network called directly on the card; ms per batch.
   c. 8c's config as ``SelfSupModel`` on ``PackNet01`` at
      ``FULL_CHANNELS`` (batch 3, 384x1280, fp32, 2 contexts): 2 warm-up
      and 3 timed steps, ms, the parts, peak memory.
   d. ``GenericSelfSupModel`` on 8c's batch cut to 2 images: 1 warm-up and
      3 timed steps, ms and peak memory; then ``project_generic``'s
      forward time inside one step, by CUDA events around each call.
14. ``ops/canny.canny_sweep`` (plain PyTorch, no kernel: the NMS kernel
   must launch 0 times) on [4,375,1242] uint8-range noisy blocky scenes
   at the edge-AUC protocol's 12 thresholds (t/2, t) on the card against
   the CPU: >= 99.99 % of pixels agree (``atan2`` buckets may part at a
   boundary); ms a sweep by CUDA events, dilation steps, host checks.

Prints one line per phase, each phase's wall time, then the card's name
and power limit, a JSON line of the kernels (with the 3-D conv, warp and
GroupNorm + ELU kernels' launches in this process by phase: ranks and CLIs spawned in processes of
their own count apart), and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits nonzero; without a CUDA
device it exits nonzero and prints no result.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from mindtheedge_tpu_torch import serve
from mindtheedge_tpu_torch.cli.infer_edge_estimation import annotate_batch
from mindtheedge_tpu_torch.cli import infer_edges, train_edges
from mindtheedge_tpu_torch.cli.infer_edges import infer_batch
from mindtheedge_tpu_torch.config import get_cfg_defaults, parse_train_file
from mindtheedge_tpu_torch.geometry import camera_generic
from mindtheedge_tpu_torch.models.packnet import FULL_CHANNELS, SLIM_CHANNELS, to_train_device
from mindtheedge_tpu_torch.models.tasks import GenericSelfSupTask, build_depth_net, build_task
from mindtheedge_tpu_torch.ops import edge_ops, wire
from mindtheedge_tpu_torch.ops.cuda import build, conv3d_kernel, gn_elu_kernel, nms_kernel, warp_kernel
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.parallel.mesh import all_reduce_mean, make_dp_train_step
from mindtheedge_tpu_torch.training.checkpoint import load_checkpoint
from mindtheedge_tpu_torch.training.experiment import Experiment
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from mindtheedge_tpu_torch.utils.depth import inv2depth
from tests.test_torch_canny_cuda import SWEEP as CANNY_SWEEP, canny_card_vs_cpu
from tests.test_torch_conv3d_kernel_cuda import REQUEST_SHAPES as CONV3D_SHAPES, check_against_conv3d
from tests.test_torch_gn_elu_kernel_cuda import (
    NETWORK_SHAPES as GN_SHAPES, ODD_SHAPES as GN_ODD_SHAPES, check_against_fp64 as gn_vs_fp64,
    group_norm_shapes, operands as gn_operands)
from tests.test_torch_annotate_cuda import (
    annotate_card_vs_cpu, random_frames, task_config)
from tests.test_torch_dp_cuda import (
    dp_vs_plain, oracle_gaps, oracle_job, sharded_step_job, start_ranks, timed_outcome)
from tests.test_torch_spatial_cuda import (
    card_pair_job, cli_job, forward_gap, gloo_dtype_job, step_gaps)
from tests.test_torch_train_cuda import write_kitti_tree
from tests.test_torch_warp_kernel_cuda import (
    ELEM_RTOL, RAGGED as WARP_RAGGED, SUM_RTOL, kernel_vs_plain, plain as plain_coords,
    warp_inputs)
from mindtheedge_tpu_torch.geometry.pose import pose_vec2mat
from tests.test_torch_variants_cuda import (
    EVAL_CASES, GENERIC_STEP_BAND, PACKNET01_SELFSUP, camera_generic_card_vs_fp64,
    eval_card_vs_cpu, generic_step_card_vs_cpu, generic_step_job, group_norm_fp64_gaps,
    patch_logits_card_vs_cpu)
from tests.test_torch_nms_kernel import dyadic_patch, gaussian_blur, misaligned
from tests.test_torch_train_cuda import (
    BAND, GRAD_RTOL, PHOTOMETRIC_BOUND, TASKS, bf16_card_vs_cpu, kitti_intrinsics,
    photometric_card_vs_cpu, photometric_gap_causes, remat_config, remat_vs_plain,
    step_outcome, synthetic_batch, tensor_errs, train_step_card_vs_cpu)

KERNELS = build.KERNELS
B, H, W = 4, 384, 1280
WARMUP, REQUESTS = 2, 5      # phases 4-6; cut from 8 when training joined
DEE_SHAPES = ((1, 192, 640), (1, 96, 320), (1, 48, 160))   # annotation scales
SCALES = 4                      # annotation scales of the DEE network
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
NMS_FLOPS_PER_PX = 40           # separable Sobel-5 pair (32) + bucket tests
CONV3D_FEATURES = 4             # NUM_3D_FEAT: the d of every network's pack layers
CONV3D_PER_PASS = 10            # the pack layers' convs in one network pass
GN_PER_PASS = 47                # the GroupNorm + ELU blocks of one network pass
GN_BYTES = {'forward': 6, 'backward': 14}   # the pair's least bytes an element
GN_SHAPE = (3, 384, 1280)       # phase gn_elu: the self-supervised cell's frames
WARPS_PER_STEP = 8              # the photometric loss's warps: 2 contexts x 4 scales
WARP_SHAPE = (3, 384, 1280)     # phase warp: the self-supervised cell's frames
TRAIN_CONFIG = 'configs/train_packnet_san_kitti_with_edges.yaml'
ANNOTATE_CONFIG = 'configs/annotate_edges_kitti_training_set.yaml'
SERVE_BF16_REQUESTS = 10        # phase 10a
PRECISION = {torch.float32: 'fp32', torch.bfloat16: 'bf16'}
TRAIN_B, TRAIN_WARMUP, TRAIN_STEPS = 3, 2, 5   # 10 steps until phase 8 joined
SMOKE_DIR = 'build/train_smoke'
KITTI_DIR = 'build/train_smoke_kitti'
KITTI_H, KITTI_W = 96, 320
EVAL_CONFIG = 'configs/infer_packnet_kitti.yaml'
EVAL_DIR = 'build/eval_smoke'
EVAL_FRAMES = 56     # KITTI-DE's split has 115 (kitti_115_split.txt); cut when phases 13 and conv3d joined
EVAL_H, EVAL_W = 375, 1242              # KITTI's frames and GT
EVAL_THRESHOLDS = 12                    # Canny thresholds 20..240 of the protocol
DP_DIR = 'build/dp_smoke'
# 11a: the loss of each of 7 steps against 7b's.  The card's nondeterministic
# reductions decide near-ties of the edge loss, so runs of the same
# arithmetic part onto trajectories up to 3.9e-3 apart by the 7th step (7b
# against 10e's remat runs and against 11a, NVIDIA H100 80GB HBM3, 700 W)
RUN_RTOL = 1e-2
DP_INFER_FRAMES = 8                     # phase 11d: the first frames of phase 9's split
SPATIAL_DIR = 'build/spatial_smoke'
SPATIAL_ITERS = 5                       # 12a: timed forwards of each kind, in turn
DDAD_CONFIG = 'configs/eval_ddad_de.yaml'
DDAD_H, DDAD_W = 1216, 1936             # DDAD-DE's frames
DDAD_SHAPE = (1216, 1920)               # rounded down to a multiple of 32
DDAD_FRAMES = 2
SHARDED_B, SHARDED_STEPS = 4, 3        # 11e: the global batch, 2 a rank; timed steps
GENERIC_B, GENERIC_SHARDED_STEPS = 2, 2  # 11f and 13d: the global batch (1 a rank in 11f)
# 11f: the sharded generic step's gradients against the plain step's, by
# relative L2 (of the plain step's norm) of each network: below 1, the
# gap a zero gradient would show.  Both are fp32 roundings of one
# ill-conditioned function (ROADMAP L4), which no tighter bound separates:
# at [2,64,96] the card's fp32 step lay up to 0.560 (depth) / 0.237 (pose)
# from fp64 by process, the CPU's 0.065 / 0.107, a process's two steps 1e-6
# apart; at full width the sharded and plain steps lay 0.375 / 0.330 apart
# (NVIDIA H100 80GB HBM3, 700 W).  A chunk's batch statistics or a missed
# gather shows in the loss and the running statistics, held at 1e-4, and the
# CPU tests hold the sharded step's gradients in fp64 (tests/test_torch_dp.py)
GENERIC_SHARDED_L2 = 1.0
PAIR_WAIT_S = 900                       # the rank pair's jobs of phases 11 and 12, all told
# The pair's two fresh processes autotune every conv shape of their jobs at
# once on the one card: its jobs took 461.9 s timing PyTorch's default of
# 10 cuDNN candidates a conv, 253.1 s timing 3 (NVIDIA H100 80GB HBM3,
# 700 W).  Their steps are held to oracles; their times are no speed figure.
PAIR_CUDNN_LIMIT = 3
CANNY_SHAPE = (4, 375, 1242)            # 14: KITTI-size images, uint8 range
VARIANTS_DIR = 'build/variants_smoke'
EDGE_FRAMES = 8                         # 13b: KITTI-size frames with an rgb_edge column


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: {what}')


def event_ms(fn, iters):
    """Mean device ms of ``fn(i)`` over ``iters`` back-to-back calls, by CUDA
    events.  The stream first sleeps ~0.5 s so that the host has enqueued
    every call before the first one runs: the events then see device time,
    not the wrapper's launch overhead."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    check(enqueue_s < 0.25, f'enqueueing {iters} calls took {enqueue_s:.3f} s')
    return start.elapsed_time(end) / iters


def nms_bound_ms(numel):
    """(least ms the card could take for NMS of ``numel`` pixels, 'bytes'
    or 'operations'): one f32 read and one write a pixel at 3.35 TB/s, or
    the flops at 67 TFLOP/s, whichever is larger."""
    bytes_ms = 2 * 4 * numel / HBM_BYTES_PER_S * 1e3
    flops_ms = NMS_FLOPS_PER_PX * numel / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), 'bytes' if bytes_ms >= flops_ms else 'operations'


def conv3d_bound_ms(xs, d):
    """(least ms the card could take for the 3-D convs of the [B,D,H,W]
    inputs ``xs`` to ``d`` features, 'bytes' or 'operations'): each input
    element read once and each output written once at 3.35 TB/s, or 27 FMAs
    an output at 67 TFLOP/s, whichever is larger."""
    n_in = sum(x.numel() for x in xs)
    bytes_ms = (1 + d) * n_in * xs[0].element_size() / HBM_BYTES_PER_S * 1e3
    flops_ms = 2 * 27 * d * n_in / FP32_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), 'bytes' if bytes_ms >= flops_ms else 'operations'


def check_gn_launches(label, gns, convs, dtype):
    """Hold the GroupNorm + ELU kernel's ``gns`` launches on a path to
    ``GN_PER_PASS`` a PackNet pass (``CONV3D_PER_PASS`` 3-D conv launches,
    ``convs`` in all) in bf16 and to none in fp32."""
    want = GN_PER_PASS * convs / CONV3D_PER_PASS if dtype == torch.bfloat16 else 0
    check(gns == want, f'{label}: the GroupNorm + ELU kernel launched {gns:g} times beside '
                       f'{convs:g} 3-D conv launches in {PRECISION[dtype]} (want {want:g})')


def compare_nms(x):
    """Kernel vs plain version on one card tensor -> (mismatches, max |err|)."""
    got = nms_kernel.non_max_suppression(x)
    torch.cuda.synchronize()
    want = edge_ops.non_max_suppression(x)
    both = (got > 0) & (want > 0)
    check(torch.equal(got[both], want[both]),
          f'kept NMS values differ at {tuple(x.shape)}')
    return (int((got != want).sum()), float((got - want).abs().max()))


def phase_build():
    t0 = time.perf_counter()
    reports = build.build(*KERNELS)
    secs = time.perf_counter() - t0
    for name in KERNELS:
        check(build.library_path(name).exists(), f'{name} did not build')
    print(f'phase 1 build: {len(reports)} of {len(KERNELS)} kernel(s) '
          f'compiled in {secs:.2f} s')
    for name, report in reports.items():
        for line in report.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')


def phase_kernel_vs_plain(dev):
    rng = np.random.RandomState(0)
    noise = rng.rand(B, H, W).astype(np.float32)
    smooth = np.stack([gaussian_blur(n) * 4.0 for n in noise[:2]])
    inputs = {'noise[4,384,1280]': noise, 'smooth[2,384,1280]': smooth}
    for shape in ((2, 192, 640), (2, 96, 320), (2, 48, 160), (3, 37, 53),
                  (2, 70, 130), (1, 5, 7), (4, 3, 3), (2, 11, 4), (1, 9, 124),
                  (4, 383, 1280), (2, 401, 1283)):
        inputs['noise' + str(list(shape)).replace(' ', '')] = (
            rng.rand(*shape).astype(np.float32))
    inputs['misaligned[2,48,160]'] = rng.rand(2, 48, 160).astype(np.float32)
    inputs['misaligned[4,384,1280]'] = rng.rand(B, H, W).astype(np.float32)
    inputs['dyadic[9,9]'] = dyadic_patch()
    total_px = total_bad = 0
    max_err = 0.0
    for name, img in inputs.items():
        x = torch.from_numpy(img).to(dev)
        if name.startswith('misaligned'):
            x = misaligned(x)
        bad, err = compare_nms(x)
        check(bad <= 1e-4 * img.size, f'NMS {name}: {bad} mismatches')
        if name.startswith('dyadic'):
            check(bad == 0, f'NMS {name}: {bad} mismatches')
        total_px, total_bad = total_px + img.size, total_bad + bad
        max_err = max(max_err, err)
        print(f'phase 2 nms kernel vs plain {name}: {bad} of {img.size} '
              f'pixels differ, max |err| {err}')
    return total_px, total_bad, max_err


def phase_small_slice(dev):
    cpu_model = serve.build((16,) * 6, device='cpu', seed=1)
    card_model = serve.build((16,) * 6, device=dev, seed=1)
    rng = np.random.RandomState(1)
    rgb_u8 = torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8))
    lidar = rng.rand(2, 64, 96, 1).astype(np.float32) * 80.0
    lidar[rng.rand(2, 64, 96, 1) < 0.95] = 0.0
    lidar = torch.from_numpy(lidar)
    rgb = rgb_u8.float() / 255.0
    with torch.no_grad():
        want = cpu_model(rgb, lidar)['inv_depths']
        got = card_model(rgb.to(dev), lidar.to(dev))['inv_depths']
    worst = 0.0
    for scale, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f'scale {scale}: {m}')
        worst = max(worst, float((g.cpu() - w).abs().max()))
    depth_c, edges_c = serve.serve(card_model, rgb_u8, lidar)
    depth_h, edges_h = serve.serve(cpu_model, rgb_u8, lidar)
    dq = (depth_c.cpu().to(torch.int64) - depth_h.to(torch.int64)).abs().max()
    agree = (wire.unpack_edges(edges_c.cpu()) == wire.unpack_edges(edges_h)
             ).float().mean().item()
    check(int(dq) <= 1 and agree >= 0.99,
          f'small serve card vs cpu: depth codes differ by {int(dq)}, '
          f'edges agree on {agree:.5f}')
    print(f'phase 3 small slice card vs cpu: 4 scales within rtol 1e-4 '
          f'atol 1e-5 (max |err| {worst}); serve depth codes within '
          f'{int(dq)}, edge bits agree on {agree:.6f}')
    shares = annotate_card_vs_cpu(dev)
    for scale, (edge, normals) in enumerate(shares):
        check(edge >= 0.999 and normals >= 0.999,
              f'small annotate_batch card vs cpu, scale {scale}: edges within '
              f'1e-4 on {edge:.5f}, normals within one code on {normals:.5f}')
    print('phase 3 small annotate_batch card vs cpu [2,64,96]: edges within '
          '1e-4 on '
          + ', '.join(f'{e:.5f}' for e, _ in shares) + '; normals within one '
          'code on ' + ', '.join(f'{n:.5f}' for _, n in shares)
          + ' (scales 0-3); hysteresis bit-equal')


def serve_requests(n):
    """``n`` seeded full-width requests, pinned: uint8 rgb shifted by i,
    set LiDAR points moved by i mm."""
    rng = np.random.RandomState(0)
    rgb_base = rng.randint(0, 256, (B, H, W, 3)).astype(np.int64)
    lidar_base = rng.rand(B, H, W, 1).astype(np.float32) * 80.0
    lidar_base[rng.rand(B, H, W, 1) < 0.95] = 0.0
    return [(torch.from_numpy(((rgb_base + i) % 256).astype(np.uint8)).pin_memory(),
             torch.from_numpy(lidar_base + np.float32(i * 1e-3) * (lidar_base > 0)
                              ).pin_memory())
            for i in range(n)]


def phase_serve(dev, dtype=torch.float32, timed=REQUESTS, label='phase 4'):
    """``WARMUP`` + ``timed`` requests through ``serve.serve`` of the model
    built in ``dtype`` -> (NMS launches, the last request's probability
    map, its NMS mismatches against the plain version, max |err|, the
    model, the requests, mean ms per request)."""
    model = serve.build(SLIM_CHANNELS, device=dev, seed=0, dtype=dtype)
    requests = serve_requests(WARMUP + timed)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    nms_kernel.launches = 0
    convs_before, gns_before = conv3d_kernel.launches, gn_elu_kernel.launches
    device_ms, wall_ms = [], []
    for i, (rgb_u8, lidar) in enumerate(requests):
        if i == WARMUP:     # the warm-up peak holds cuDNN's autotuning
            tuning_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start.record()
        depth_wire, edges_wire = serve.serve(model, rgb_u8, lidar, wire='u16')
        depth_host, edges_host = depth_wire.cpu(), edges_wire.cpu()
        end.record()
        end.synchronize()
        if i >= WARMUP:
            device_ms.append(start.elapsed_time(end))
            wall_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nms_kernel.launches
    convs = conv3d_kernel.launches - convs_before
    gns = gn_elu_kernel.launches - gns_before
    peak = torch.cuda.max_memory_allocated()
    check_gn_launches(label, gns, convs, dtype)
    check(launches == len(requests),
          f'NMS kernel launched {launches} times in {len(requests)} requests')
    check(convs == CONV3D_PER_PASS * len(requests),
          f'3-D conv kernel launched {convs} times in {len(requests)} requests')

    check(depth_host.dtype == torch.uint16 and depth_host.shape == (B, H, W),
          f'depth wire {depth_host.dtype} {tuple(depth_host.shape)}')
    check(edges_host.dtype == torch.uint8 and edges_host.shape == (B, H, W // 8),
          f'edge wire {edges_host.dtype} {tuple(edges_host.shape)}')
    depth = wire.decode_depth_u16(depth_host)
    edge_share = wire.unpack_edges(edges_host).float().mean().item()
    check(bool(torch.isfinite(depth).all()) and float(depth.min()) >= 0.5,
          f'depth out of range [{float(depth.min())}, {float(depth.max())}]')
    check(edge_share < 0.5, f'edge share {edge_share}')
    mean_ms = float(np.mean(device_ms))
    print(f'{label} serve 384x1280 b{B} {PRECISION[dtype]}: {timed} requests after '
          f'{WARMUP} warm-up, {mean_ms:.3f} ms/batch on the device '
          f'(min {min(device_ms):.3f}, max {max(device_ms):.3f}; host wall '
          f'{float(np.mean(wall_ms)):.3f}), {B * 1e3 / mean_ms:.2f} img/s, '
          f'peak {peak / 2**30:.3f} GiB (warm-up with cuDNN autotuning '
          f'{tuning_peak / 2**30:.3f} GiB), nms launches {launches} '
          f'({launches / len(requests):g} per request), 3-D conv launches {convs} '
          f'({convs / len(requests):g} per request), GroupNorm + ELU kernel launches {gns} '
          f'({gns / len(requests):g} per request), depth '
          f'[{float(depth.min()):.3f}, {float(depth.max()):.3f}] m, '
          f'edge share {edge_share:.4f}')

    # the kernel on the probability map the main path gave it (f32)
    rgb_u8, lidar = requests[-1]
    with torch.no_grad():
        inv = model((rgb_u8.to(dev).float() / 255.0).to(dtype), lidar.to(dev, dtype))[
            'inv_depths'][0][..., 0].float()
    prob = torch.clamp(inv / 2.0, 0.0, 1.0)
    bad, err = compare_nms(prob)
    check(bad <= 1e-4 * prob.numel(), f'NMS on the served map: {bad} mismatches')
    kept = (edge_ops.non_max_suppression(prob) > 0).float().mean().item()
    check(0.0 < kept < 1.0, f'NMS kept {kept} of the served map')
    print(f'{label} nms kernel vs plain on the served map: {bad} of '
          f'{prob.numel()} pixels differ, max |err| {err}; NMS keeps {kept:.4f}')
    return launches, prob, bad, err, model, requests, mean_ms


def profiled_kernel_us(fn, iters):
    """(CUDA-events mean ms of ``event_ms(fn, iters)`` run under
    ``torch.profiler``, the profiler's mean device us of the NMS kernel in
    that run, or None where it shows no device time)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms = event_ms(fn, iters)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and 'nms_sobel5_kernel' in e.key]
    count = sum(e.count for e in rows)
    if not count or not sum(e.self_device_time_total for e in rows):
        return ms, None
    return ms, sum(e.self_device_time_total for e in rows) / count


def time_nms(prob):
    """Kernel and plain version at [4,384,1280] on 8 inputs in turn, 63 MB,
    more than the 50 MB L2, so each call reads its input from HBM; then the
    kernel on the served map ``prob`` (warm in L2, as on the main path), a
    copy of the same bytes, the kernel at the DEE annotation scales (one
    input each), and last the 8-input run again under ``torch.profiler``."""
    dev = prob.device
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand(B, H, W, device=dev, generator=gen) for _ in range(8)]
    for x in xs:
        nms_kernel.non_max_suppression(x)
        edge_ops.non_max_suppression(x)
    rotate = lambda i: nms_kernel.non_max_suppression(xs[i % 8])
    kernel_ms = event_ms(rotate, 400)
    plain_ms = event_ms(lambda i: edge_ops.non_max_suppression(xs[i % 8]), 4)
    warm_ms = event_ms(lambda i: nms_kernel.non_max_suppression(prob), 400)
    # a yardstick, not the function: moving the same bytes, device to device
    copy_to = torch.empty_like(xs[0]).copy_(xs[0])
    copy_ms = event_ms(lambda i: copy_to.copy_(xs[i % 8]), 400)
    bound_ms, bound_by = nms_bound_ms(B * H * W)
    print(f'nms timing [4,384,1280], 8 inputs in turn: kernel '
          f'{kernel_ms * 1e3:.3f} us by CUDA events, bound '
          f'{bound_ms * 1e3:.3f} us ({bound_by}), '
          f'{100 * bound_ms / kernel_ms:.1f} % of bound; plain '
          f'{plain_ms * 1e3:.2f} us')
    print(f'nms timing on the served map {list(prob.shape)}, warm in L2: '
          f'{warm_ms * 1e3:.3f} us')
    print(f'copy of the same bytes [4,384,1280] (torch copy_, 8 inputs in '
          f'turn): {copy_ms * 1e3:.3f} us')
    for shape in DEE_SHAPES:
        x = torch.rand(*shape, device=dev, generator=gen)
        nms_kernel.non_max_suppression(x)
        ms = event_ms(lambda i: nms_kernel.non_max_suppression(x), 400)
        bound, _ = nms_bound_ms(x.numel())
        print(f'nms timing {list(shape)}: {ms * 1e3:.3f} us per launch, '
              f'bound {bound * 1e3:.3f} us')
    prof_events_ms, prof_us = profiled_kernel_us(rotate, 400)
    print(f'nms timing [4,384,1280] under torch.profiler: CUDA events '
          f'{prof_events_ms * 1e3:.3f} us per launch, kernel duration '
          + ('not shown (the profiler shows no device time)' if prof_us is None
             else f'{prof_us:.3f} us, gap between launches '
                  f'{prof_events_ms * 1e3 - prof_us:.3f} us'))
    return kernel_ms, plain_ms, bound_ms, bound_by


def phase_conv3d(dev):
    """The 3-D conv kernel at the ten [4,D,H,W] shapes of a batch-4 request,
    fp32, bf16 and bf16 channels-last ('bf16_nhwc', the bf16 networks'
    layout), against ``F.conv3d`` on the same inputs (drawn on the card:
    input N(0, 1), weight and bias U(-1, 1) / sqrt(27)); then a request's
    ten convs by CUDA events, each shape in turn, and each bf16 shape alone
    in both layouts -> (elements checked, the largest error over its
    tolerance, {tag: kernel ms a request}, {tag: ``F.conv3d`` ms}, {tag:
    bound ms}, {tag: what bounds it}, {tag: {shape: kernel ms}})."""
    check(not torch.backends.cudnn.allow_tf32, 'TF32 is on in cuDNN convs')
    gen = torch.Generator(device=dev).manual_seed(0)
    uniform = lambda *shape: (torch.rand(*shape, device=dev, generator=gen) * 2 - 1) / 27 ** 0.5
    checked, worst = 0, 0.0
    kernel_ms, plain_ms, bound_ms, bound_by, shape_ms = {}, {}, {}, {}, {}
    for dtype, tag, layout in ((torch.float32, 'fp32', torch.contiguous_format),
                               (torch.bfloat16, 'bf16', torch.contiguous_format),
                               (torch.bfloat16, 'bf16_nhwc', torch.channels_last)):
        calls, worst_here = [], 0.0
        for name, (depth, h, w) in CONV3D_SHAPES.items():
            x, weight, bias = (t.to(dtype) for t in (
                torch.randn(B, depth, h, w, device=dev, generator=gen),
                uniform(CONV3D_FEATURES, 1, 3, 3, 3), uniform(CONV3D_FEATURES)))
            x = x.contiguous(memory_format=layout)
            err = check_against_conv3d(x, weight, bias)
            check(err <= 1.0, f'3-D conv kernel {tag} {name} [{B},{depth},{h},{w}]: '
                              f'{err:.3f} x its tolerance')
            checked += CONV3D_FEATURES * x.numel()
            worst_here = max(worst_here, err)
            calls.append((x, weight, bias))
            conv3d_kernel.plain(x, weight, bias)       # cuDNN's autotuning, outside the timing
        per_request = len(calls)
        kernel_ms[tag] = per_request * event_ms(
            lambda i: conv3d_kernel.launch(*calls[i % per_request]), 20 * per_request)
        plain_ms[tag] = per_request * event_ms(
            lambda i: conv3d_kernel.plain(*calls[i % per_request]), 2 * per_request)
        bound_ms[tag], bound_by[tag] = conv3d_bound_ms([c[0] for c in calls], CONV3D_FEATURES)
        if dtype == torch.bfloat16:
            shape_ms[tag] = {name: event_ms(lambda i: conv3d_kernel.launch(*c), 20)
                             for name, c in zip(CONV3D_SHAPES, calls)}
        worst = max(worst, worst_here)
        print(f'phase conv3d {tag}: the kernel within its tolerance of F.conv3d at the ten '
              f'request shapes (worst {worst_here:.3f} x the tolerance); a request\'s ten convs '
              f'{kernel_ms[tag]:.3f} ms by CUDA events, F.conv3d {plain_ms[tag]:.3f} ms '
              f'({plain_ms[tag] / kernel_ms[tag]:.1f} x), bound {bound_ms[tag]:.3f} ms '
              f'({bound_by[tag]}; the kernel {kernel_ms[tag] / bound_ms[tag]:.2f} x)')
        del calls
    print('phase conv3d each bf16 request shape alone, kernel ms by CUDA events (NCHW / NHWC): '
          + ', '.join(f'{n} {shape_ms["bf16"][n]:.4f} / {shape_ms["bf16_nhwc"][n]:.4f}'
                      for n in CONV3D_SHAPES))
    return checked, worst, kernel_ms, plain_ms, bound_ms, bound_by, shape_ms


def phase_gn_elu(dev):
    """The GroupNorm + ELU kernel pair (``gn_elu_kernel.GroupNormEluFn``,
    forward and backward) against fp64 and the plain version
    ``F.elu(F.group_norm(x))`` at every GroupNorm shape of PackNet01 FULL
    and SLIM at [3,384,1280] and at [2,37,101] x 6 widths, at the card
    test's tolerances (``tests/test_torch_gn_elu_kernel_cuda``); then the 47
    GroupNorms of a FULL pass at [3,384,1280], each shape by CUDA events:
    the forward, the backward, the Function's forward + backward, and the
    plain version's (ATen on the same channels-last input) -> (shapes
    checked, the largest error over its tolerance, {pass: kernel ms a
    network pass}, {pass: plain ms}, {pass: bound ms})."""
    shapes = GN_SHAPES + GN_ODD_SHAPES
    worst = 0.0
    for shape in shapes:
        errs = gn_vs_fp64(*gn_operands(*shape, dev))
        over = max(errs[k] for k in ('y', 'dx', 'dweight', 'dbias'))
        gap = max(errs[k] for k in ('gap_y', 'gap_dx', 'gap_dweight', 'gap_dbias'))
        check(over <= 1.0 and errs['y'] <= errs['plain_y'] and gap < 0.05,
              f'GroupNorm + ELU kernel pair at {list(shape)}: {errs}')
        worst = max(worst, over)
    per_pass = {}
    for c, h, w in group_norm_shapes(FULL_CHANNELS, *GN_SHAPE[1:]):
        per_pass[(GN_SHAPE[0], c, h, w)] = per_pass.get((GN_SHAPE[0], c, h, w), 0) + 1
    check(sum(per_pass.values()) == GN_PER_PASS, f'{sum(per_pass.values())} GroupNorms a pass')
    kernel_ms = dict.fromkeys(('forward', 'backward', 'forward_backward'), 0.0)
    plain_ms = dict.fromkeys(('forward', 'forward_backward'), 0.0)
    elements = 0
    for shape, n in per_pass.items():
        x, weight, bias, dy = gn_operands(*shape, dev)
        y, mean, rstd = gn_elu_kernel.launch(x, weight, bias)
        xr = x.detach().clone().requires_grad_()
        both = lambda i: gn_elu_kernel.GroupNormEluFn.apply(xr, weight, bias, 1e-5).backward(dy)
        plain_both = lambda i: gn_elu_kernel.plain(xr, weight, bias).backward(dy)
        both(0)
        plain_both(0)
        kernel_ms['forward'] += n * event_ms(lambda i: gn_elu_kernel.launch(x, weight, bias), 20)
        kernel_ms['backward'] += n * event_ms(
            lambda i: gn_elu_kernel.launch_backward(dy, x, y, mean, rstd, weight), 20)
        kernel_ms['forward_backward'] += n * event_ms(both, 20)
        plain_ms['forward'] += n * event_ms(lambda i: gn_elu_kernel.plain(x, weight, bias), 5)
        plain_ms['forward_backward'] += n * event_ms(plain_both, 5)
        elements += n * x.numel()
    bound_ms = {k: GN_BYTES[k] * elements / HBM_BYTES_PER_S * 1e3 for k in GN_BYTES}
    print(f'phase gn_elu: forward and backward within the card test\'s tolerances of fp64 and '
          f'closer than ATen at {len(shapes)} shapes (worst {worst:.3f} x the tolerance); the '
          f'{GN_PER_PASS} GroupNorms of a PackNet01 FULL pass at {list(GN_SHAPE)} by CUDA '
          f'events: forward {kernel_ms["forward"]:.3f} ms, backward {kernel_ms["backward"]:.3f} '
          f'ms (bound {bound_ms["forward"]:.3f} / {bound_ms["backward"]:.3f} ms, bytes), the '
          f'Function\'s forward + backward {kernel_ms["forward_backward"]:.3f} ms; ATen\'s '
          f'plain version forward {plain_ms["forward"]:.3f} ms, forward + backward '
          f'{plain_ms["forward_backward"]:.3f} ms')
    return shapes, worst, kernel_ms, plain_ms, bound_ms


def warp_bound_ms(pixels):
    """{pass: least ms the card could take for the warp's geometry over
    ``pixels`` pixels}: the forward reads 4 B a pixel and writes 8, the
    backward reads 12 and writes 4, at 3.35 TB/s."""
    return {'forward': 12 * pixels / HBM_BYTES_PER_S * 1e3,
            'backward': 16 * pixels / HBM_BYTES_PER_S * 1e3}


def phase_warp(dev):
    """The warp's geometry kernel pair (``warp_kernel.WarpCoordsFn``, forward
    and backward) against autograd of the plain chain,
    ``project(reconstruct(...))``, on the same inputs and against its fp64,
    at the four scales of [3,384,1280] and a ragged [2,37,101], at the card
    test's tolerances (``tests/test_torch_warp_kernel_cuda``: each error at
    most twice the plain fp32's, or within 1e-5); then, at [3,384,1280],
    the forward and the backward by CUDA events, the Function's forward +
    backward as the host drives it, and the plain chain's -> (shapes
    checked, the largest error over its tolerance, {pass: kernel ms},
    {pass: plain ms}, {pass: bound ms})."""
    b, h, w = WARP_SHAPE
    shapes = [(b, h >> s, w >> s) for s in range(4)] + [WARP_RAGGED]
    worst = 0.0
    for shape in shapes:
        err = kernel_vs_plain(shape, dev)
        over = max(err[name] / max(2 * err[f'plain_{name}'], tol) for name, tol in
                   (('coords', ELEM_RTOL), ('depth_grad', ELEM_RTOL), ('pose_grad', SUM_RTOL)))
        check(over <= 1.0, f'warp kernel at {list(shape)}: {over:.3f} x its tolerance ({err})')
        worst = max(worst, over)
    depth, K, ref_K, vec, grad = warp_inputs(WARP_SHAPE, dev)
    pose = pose_vec2mat(vec)

    def fwd_bwd(fn):
        d, p = depth.detach().requires_grad_(), pose.detach().requires_grad_()
        torch.autograd.backward(fn(d, K, ref_K, p), grad)

    fwd_bwd(warp_kernel.WarpCoordsFn.apply)     # a warm call, as every timing here has
    kernel_ms = {
        'forward': event_ms(lambda i: warp_kernel.launch(depth, K, ref_K, pose), 200),
        'backward': event_ms(
            lambda i: warp_kernel.launch_backward(grad, depth, K, ref_K, pose), 200),
        'forward_backward_host_driven': sync_ms(
            lambda i: fwd_bwd(warp_kernel.WarpCoordsFn.apply), 200)}
    fwd_bwd(plain_coords)
    plain_ms = {'forward': event_ms(lambda i: plain_coords(depth, K, ref_K, pose), 20),
                'forward_backward': event_ms(lambda i: fwd_bwd(plain_coords), 5)}
    bound_ms = warp_bound_ms(depth.numel())
    print(f'phase warp: forward and backward within the card test\'s tolerances of the '
          f'plain chain at {shapes} (worst {worst:.3f} x the tolerance); at '
          f'{list(WARP_SHAPE)} by CUDA events: forward {kernel_ms["forward"] * 1e3:.2f} us, '
          f'backward {kernel_ms["backward"] * 1e3:.2f} us (bound '
          f'{bound_ms["forward"] * 1e3:.2f} / {bound_ms["backward"] * 1e3:.2f} us, bytes), '
          f'the Function\'s forward + backward as the host drives it '
          f'{kernel_ms["forward_backward_host_driven"] * 1e3:.2f} us; the plain chain '
          f'forward {plain_ms["forward"]:.3f} ms, forward + backward '
          f'{plain_ms["forward_backward"]:.3f} ms')
    return shapes, worst, kernel_ms, plain_ms, bound_ms


def sync_ms(fn, iters):
    """Mean ms of ``fn(i)`` over ``iters`` calls by CUDA events, for work
    that waits for the card itself (so ``event_ms``'s enqueue check cannot
    hold): events around the calls, then wait."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def frames(seed, i, scale_lidar=1.0):
    """Batch ``i`` of a seeded full-width stream, pinned: rgb shifted by
    i/256 and set LiDAR points moved by i/256 m (staying on the uint16 PNG
    grid), the LiDAR then multiplied by ``scale_lidar``."""
    rgb, lidar = random_frames(np.random.RandomState(seed), B, H, W)
    rgb = (rgb + i / 256.0) % 1.0
    lidar = (lidar + (i / 256.0) * (lidar > 0)) * scale_lidar
    return rgb.pin_memory(), lidar.pin_memory()


def annotate_run(dev, task, timed, label):
    """``WARMUP`` + ``timed`` full-width batches through ``annotate_batch``
    -> (NMS launches, the batches, the last batch's results, mean ms)."""
    batches = [frames(5, i, 1.0 / 200.0) for i in range(WARMUP + timed)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    nms_kernel.launches = 0
    convs_before, gns_before = conv3d_kernel.launches, gn_elu_kernel.launches
    device_ms, wall_ms = [], []
    for i, (rgb, lidar) in enumerate(batches):
        if i == WARMUP:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        start.record()
        results = annotate_batch(task, rgb.to(dev, non_blocking=True),
                                 lidar.to(dev, non_blocking=True))
        host = [(r['edge'].cpu(), r['normals'].cpu()) for r in results]
        end.record()
        end.synchronize()
        if i >= WARMUP:
            device_ms.append(start.elapsed_time(end))
            wall_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nms_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    check_gn_launches(label, gn_elu_kernel.launches - gns_before,
                      conv3d_kernel.launches - convs_before, task.compute_dtype)
    check(launches == SCALES * len(batches),
          f'NMS kernel launched {launches} times in {len(batches)} '
          f'annotation batches')
    for s, (edge, normals) in enumerate(host):
        shape = (B, H >> s, W >> s)
        check(tuple(edge.shape) == shape and tuple(normals.shape) == shape,
              f'scale {s}: edge {tuple(edge.shape)} normals {tuple(normals.shape)}')
        check(bool(torch.isfinite(edge).all()) and 0.0 <= float(edge.min())
              and float(edge.max()) <= 1.0 and float(edge.max()) > 0.0,
              f'scale {s}: edge values [{float(edge.min())}, {float(edge.max())}]')
        check(0.0 <= float(normals.min()) and float(normals.max()) <= 255.0,
              f'scale {s}: normal codes out of [0, 255]')
    counts = [r['hysteresis'] for r in results]
    syncs = sum(c for _, c in counts) + 2 * SCALES
    mean_ms = float(np.mean(device_ms))
    print(f'{label} annotate 384x1280 b{B} {PRECISION[task.compute_dtype]}, 4 scales, '
          f'NMS + hysteresis + normals: {timed} batches after {WARMUP} warm-up, '
          f'{mean_ms:.3f} ms/batch by CUDA events (min {min(device_ms):.3f}, '
          f'max {max(device_ms):.3f}; host wall {float(np.mean(wall_ms)):.3f}), '
          f'{B * 1e3 / mean_ms:.2f} img/s, peak {peak / 2**30:.3f} GiB, nms '
          f'launches {launches} ({launches / len(batches):g} per batch), '
          f'hysteresis (iterations, checks) per scale {counts}, host syncs '
          f'per batch {syncs} ({syncs - 2 * SCALES} hysteresis checks + '
          f'{2 * SCALES} read-backs)')
    return launches, batches, results, mean_ms


def phase_annotate(dev, kernel_ms):
    """The DEE annotation path at full width -> (launches, checked pixels,
    mismatches, max |err|)."""
    task = build_task(task_config('EdgeEstimationLIDARModel'), device=dev)
    launches, batches, _, mean_ms = annotate_run(dev, task, REQUESTS, 'phase 5')

    # the last batch again, outside the counted run: each scale's kernel
    # output against the plain version, and hysteresis card vs CPU
    rgb, lidar = batches[-1]
    batch = {'rgb': rgb.to(dev), 'input_depth': lidar.to(dev)}
    forward_ms = sync_ms(lambda i: task.run_depth(batch), 3)
    inv = task.run_depth(batch)
    px = bad = 0
    max_err = 0.0
    stage_ms = {'nms': [], 'normals': [], 'hysteresis': [], 'read-back': []}
    for s in range(SCALES):
        prob = inv['inv_depths'][s][..., 0] / 2.0
        n_bad, err = compare_nms(prob)
        check(n_bad <= 1e-4 * prob.numel(), f'scale {s} NMS: {n_bad} mismatches')
        px, bad, max_err = px + prob.numel(), bad + n_bad, max(max_err, err)
        nms = nms_kernel.non_max_suppression(prob)
        on_card, iters, checks = edge_ops.hysteresis_counted(nms)
        check(torch.equal(on_card.cpu(), edge_ops.hysteresis(nms.cpu())),
              f'scale {s}: hysteresis differs card vs CPU')
        hyst_ms = sync_ms(lambda i: edge_ops.hysteresis_counted(nms), 5)
        by_interval = {k: sync_ms(lambda i: edge_ops.hysteresis_counted(
            nms, check_every=k), 5) for k in (1, 16)}
        stage_ms['hysteresis'].append(hyst_ms)
        stage_ms['nms'].append(kernel_ms if s == 0 else event_ms(
            lambda i: nms_kernel.non_max_suppression(prob), 400))
        stage_ms['normals'].append(event_ms(
            lambda i: edge_ops.normals_angle_255(prob), 20))
        stage_ms['read-back'].append(sync_ms(lambda i: (nms.cpu(), nms.cpu()), 5))
        print(f'phase 5 scale {s} {list(prob.shape)}: NMS kernel vs plain '
              f'{n_bad} of {prob.numel()} pixels differ, max |err| {err}; '
              f'kernel {stage_ms["nms"][-1] * 1e3:.3f} us'
              + (' (8 inputs in turn, nms timing above)' if s == 0 else
                 ' (warm in L2)') + f'; hysteresis bit-equal card vs CPU, '
              f'{iters} iterations, {checks} checks of every '
              f'{edge_ops.CHECK_EVERY} steps {hyst_ms:.3f} ms; checks of '
              + ', '.join(f'every {k} {v:.3f} ms' for k, v in by_interval.items())
              + f'; normals '
              f'{stage_ms["normals"][-1]:.3f} ms; read-back of edge and '
              f'normals {stage_ms["read-back"][-1]:.3f} ms')
    share = 100 * sum(stage_ms['nms']) / mean_ms
    print(f'phase 5 NMS kernel per annotation batch: {SCALES} launches, '
          f'{sum(stage_ms["nms"]) * 1e3:.3f} us, {share:.4f} % of the batch')
    print(f'phase 5 where an annotation batch goes (each stage timed alone, '
          f'ms): forward {forward_ms:.3f}, '
          + ', '.join(f'{k} {sum(v):.3f}' for k, v in stage_ms.items())
          + f'; the rest (uploads, scale halving, launch gaps) '
          f'{mean_ms - forward_ms - sum(map(sum, stage_ms.values())):.3f}')
    return launches, px, bad, max_err


def infer_run(dev, task, timed, label):
    """The batch-inference path at full width, sparse uint16 LiDAR up and
    uint16 depth down, through the CLI's own upload and read-back; the
    timed batches run with torch's sync debug mode on 'error', so any host
    sync on the path fails the phase -> (NMS launches, the last batch's rgb
    and LiDAR, its depth on the wire, mean ms)."""
    cap = H * W // 8
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    nms_kernel.launches = 0
    convs_before, gns_before = conv3d_kernel.launches, gn_elu_kernel.launches
    device_ms, encode_ms = [], []
    for i in range(WARMUP + timed):
        rgb, lidar = frames(6, i)
        t0 = time.perf_counter()
        pairs = [wire.encode_lidar_sparse(l.numpy(), cap) for l in lidar]
        idx = np.stack([p[0] for p in pairs]).view(np.int32)
        val = np.stack([p[1] for p in pairs])
        t1 = time.perf_counter()
        torch.cuda.set_sync_debug_mode('error' if i >= WARMUP else 0)
        start.record()
        sparse = (infer_edges.upload(idx, dev), infer_edges.upload(val, dev))
        depth_host, done = infer_edges.start_readback(infer_batch(
            task, infer_edges.upload(rgb.numpy(), dev), sparse, 'u16'))
        end.record()
        torch.cuda.set_sync_debug_mode(0)
        end.synchronize()
        check(done.query(), 'read-back not complete at the end event')
        if i >= WARMUP:
            device_ms.append(start.elapsed_time(end))
            encode_ms.append((t1 - t0) * 1e3)
    launches = nms_kernel.launches
    check_gn_launches(label, gn_elu_kernel.launches - gns_before,
                      conv3d_kernel.launches - convs_before, task.compute_dtype)
    check(depth_host.dtype == torch.uint16 and depth_host.shape == (B, H, W),
          f'depth wire {depth_host.dtype} {tuple(depth_host.shape)}')
    depth = wire.decode_depth_u16(depth_host)
    check(bool(torch.isfinite(depth).all()) and float(depth.min()) >= 0.5,
          f'depth out of range [{float(depth.min())}, {float(depth.max())}]')
    mean_ms = float(np.mean(device_ms))
    print(f'{label} infer 384x1280 b{B} {PRECISION[task.compute_dtype]}, sparse u16 '
          f'LiDAR up ({cap} slots a frame), u16 depth down: {timed} batches after '
          f'{WARMUP} warm-up, no host sync on the path (sync debug mode), '
          f'{mean_ms:.3f} ms/batch by CUDA events (min {min(device_ms):.3f}, '
          f'max {max(device_ms):.3f}), {B * 1e3 / mean_ms:.2f} img/s; host '
          f'sparse encode {float(np.mean(encode_ms)):.3f} ms/batch; depth '
          f'[{float(depth.min()):.3f}, {float(depth.max()):.3f}] m; nms launches {launches}')
    return launches, (rgb, lidar), depth_host, mean_ms


def phase_infer(dev):
    """Phase 6 -> NMS launches (none on this path)."""
    task = build_task(task_config('SemiSupEdgeModel'), device=dev)
    launches, (rgb, lidar), depth_host, _ = infer_run(dev, task, REQUESTS, 'phase 6')
    dense = infer_batch(task, rgb.to(dev), lidar.to(dev), 'u16').cpu()
    codes = int((dense.to(torch.int64) - depth_host.to(torch.int64)).abs().max())
    check(codes <= 1, f'sparse vs dense uplink: u16 codes differ by {codes}')
    print(f'phase 6 u16 codes within {codes} of the dense float32 uplink')
    return launches


def phase_train_small(dev):
    loss_h, loss_c, worst = train_step_card_vs_cpu(dev)
    print(f'phase 7a train_step card vs cpu [2,64,96] (16,)*6: loss {loss_c} on '
          f'the card, {loss_h} on the CPU; worst gradient error '
          f'{worst["grad_vs_max"]:.3e} of its tensor\'s largest |gradient| '
          f'(bound 1e-4); worst parameter error after the Adam step '
          f'{worst["param_vs_lr"]:.3e} lr (bound 1e-2); SAN running stats '
          f'within rtol 1e-4')


def train_config():
    """The shipped training config in strict fp32, random weights."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(TRAIN_CONFIG)
    cfg.arch.precision = 'float32'
    cfg.model.depth_net.checkpoint_path = ''
    return cfg


def blocky_scene(rng, b, h, w, dev):
    """[b,h,w] depth in metres on the card: 30 m with 12 boxes of 5-25 m."""
    depth = torch.full((b, h, w), 30.0, device=dev)
    for i in range(b):
        for _ in range(12):
            y, x = rng.randint(0, h - h // 8), rng.randint(0, w - w // 8)
            hh, ww = rng.randint(h // 16, h // 3), rng.randint(w // 16, w // 3)
            depth[i, y:y + hh, x:x + ww] = float(rng.uniform(5.0, 25.0))
    return depth


def full_width_batch(dev, seed=0, b=TRAIN_B):
    """A seeded synthetic training batch made on the card, NHWC: RGB shaded
    by depth, LiDAR 95 % sparse, GT 75 % sparse, and at each of the 4
    scales the depth edges (a step to the right or below) and the normals
    (the Sobel-5 angle of the scene, as the DEE annotation decodes it)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    h, w = H, W
    depth = blocky_scene(rng, b, h, w, dev)
    shade = (depth / 40.0)[..., None]
    batch = {'rgb': torch.clamp(shade + 0.2 * torch.rand(b, h, w, 3, device=dev,
                                                        generator=gen), 0.0, 1.0)}
    keep = lambda share: torch.rand(b, h, w, device=dev, generator=gen) < share
    batch['input_depth'] = torch.where(keep(0.05), depth, 0.0)[..., None]
    batch['depth'] = torch.where(keep(0.25), depth, 0.0)[..., None]
    for s, key in enumerate(('', '_1', '_2', '_3')):
        d = depth[:, ::2 ** s, ::2 ** s].contiguous()
        edge = torch.zeros_like(d, dtype=torch.bool)
        edge[:, :, :-1] |= d[:, :, 1:] != d[:, :, :-1]
        edge[:, :-1] |= d[:, 1:] != d[:, :-1]
        batch['edge' + key] = edge.float()[..., None]
        batch['normal' + key] = edge_ops.decode_normal_png(
            edge_ops.normals_angle_255(d))[..., None]
    return batch


def stage_ms(task, state, batch, gen):
    """The forward, the loss, the backward and the optimizer step of one
    training step, each timed alone by CUDA events between syncs (ms); for
    a task with a pose network, then the pose network's forward and the
    photometric loss (pose network included) each alone."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(12)]
    for net in state.networks():
        net.zero_grad(set_to_none=False)

    def timed(i, fn):
        torch.cuda.synchronize()
        events[2 * i].record()
        out = fn()
        events[2 * i + 1].record()
        torch.cuda.synchronize()
        return out

    batch = task.prep_batch(batch)
    out = timed(0, lambda: task.run_depth(batch, train=True, generator=gen))
    total, _ = timed(1, lambda: task.losses(batch, out))
    names = ['forward', 'loss', 'backward', 'optimizer']
    if task.pose_net is not None and not isinstance(task, GenericSelfSupTask):
        timed(4, lambda: task.run_pose(batch))
        timed(5, lambda: task._self_sup_loss(batch, out, task.run_pose(batch)))
        names += ['pose net', 'photometric loss']
    del out
    timed(2, total.backward)
    timed(3, state.optimizer.step)
    return {n: events[2 * i].elapsed_time(events[2 * i + 1]) for i, n in enumerate(names)}


def train_full(dev, cfg, batch, label, make_step=make_train_step, warmup=TRAIN_WARMUP,
               steps=TRAIN_STEPS, conv3d_per_step=None, warps_per_step=0):
    """``warmup`` + ``steps`` full-width training steps made by
    ``make_step`` of the task of ``cfg`` on ``batch``, from the weights and
    generator of ``cfg.arch.seed``, the 3-D conv kernel held to
    ``conv3d_per_step`` launches a step where that is given and the warp
    kernel to ``warps_per_step`` -> (mean ms per step, peak bytes, the loss
    of every step, warm-ups first)."""
    task = build_task(cfg, device=dev)
    net = to_train_device(task.depth_net, dev)
    state = create_train_state(cfg, net, pose_net=task.pose_net)
    step = make_step(task)
    gen = torch.Generator(dev).manual_seed(cfg.arch.seed)
    params = state.parameters()
    torch.cuda.reset_peak_memory_stats()
    convs_before, warps_before = conv3d_kernel.launches, warp_kernel.launches
    gns_before = gn_elu_kernel.launches
    warm = [step(state, batch, gen)['loss'] for _ in range(warmup)]
    torch.cuda.synchronize()
    tuning_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = [p.detach().clone() for p in params]
    running = lambda: [b for n in state.networks() for k, b in n.named_buffers() if 'running' in k]
    stats_before = [b.clone() for b in running()]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    metrics = []
    events[0].record()
    for i in range(steps):
        metrics.append(step(state, batch, gen))
        events[i + 1].record()
    events[-1].synchronize()
    peak = torch.cuda.max_memory_allocated()
    convs = (conv3d_kernel.launches - convs_before) / (warmup + steps)
    check(conv3d_per_step is None or convs == conv3d_per_step,
          f'{label}: the 3-D conv kernel launched {convs:g} times a step')
    gns = (gn_elu_kernel.launches - gns_before) / (warmup + steps)
    check_gn_launches(label, gns, convs, task.compute_dtype)
    warps = (warp_kernel.launches - warps_before) / (warmup + steps)
    check(warps == warps_per_step, f'{label}: the warp kernel launched {warps:g} times a step')
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for r in rows:
        check(all(np.isfinite(v) for v in r.values()), f'{label}: non-finite metrics {r}')
    moved = sum(not torch.equal(p.detach(), q) for p, q in zip(params, before))
    stats_moved = sum(not torch.equal(b, a) for b, a in zip(running(), stats_before))
    check(moved > 0 and (stats_moved > 0 or not stats_before),
          f'{label}: {moved} parameter tensors and {stats_moved} running statistics moved')
    mean_ms = float(np.mean(step_ms))
    stages = stage_ms(task, state, batch, gen)
    b = batch['rgb'].shape[0]
    line = (f'{label} {H}x{W} b{b} {PRECISION[task.compute_dtype]} (TF32 off), remat '
            f'{cfg.model.depth_net.remat!r}, {sum(p.numel() for p in params)} '
            f'parameters, dropout {cfg.model.depth_net.dropout}, flip '
            f'{cfg.model.loss.flip_lr_prob}: {steps} steps after {warmup} '
            f'warm-up, {mean_ms:.3f} ms/step by CUDA events (min {min(step_ms):.3f}, '
            f'max {max(step_ms):.3f}), {b * 1e3 / mean_ms:.3f} img/s, peak '
            f'{peak / 2**30:.3f} GiB (warm-up with cuDNN autotuning '
            f'{tuning_peak / 2**30:.3f} GiB); {moved} of {len(before)} parameter tensors '
            f'and {stats_moved} of {len(stats_before)} running statistics moved; '
            f'3-D conv kernel launches a step {convs:g}, warp kernel launches a step {warps:g}, '
            f'GroupNorm + ELU kernel launches a step {gns:g}')
    print(line)
    for i, r in enumerate(rows):
        print(f'{label} step {i}: {step_ms[i]:.3f} ms, '
              + ', '.join(f'{k} {v:.6f}' for k, v in sorted(r.items())))
    main = ('forward', 'loss', 'backward', 'optimizer')
    total = sum(stages[k] for k in main)
    print(f'{label} where a training step goes (each part timed alone, ms): '
          + ', '.join(f'{k} {stages[k]:.3f} ({100 * stages[k] / total:.1f} %)' for k in main)
          + f'; sum {total:.3f} vs {mean_ms:.3f} per step in the run'
          + ''.join(f'; {k} alone {v:.3f}' for k, v in stages.items() if k not in main))
    return mean_ms, peak, [float(v) for v in warm] + [r['loss'] for r in rows]


def phase_train_full(dev):
    return train_full(dev, train_config(), full_width_batch(dev), 'phase 7b train',
                      conv3d_per_step=2 * CONV3D_PER_PASS)


def phase_train_small_tasks(dev):
    """8a: one step card vs CPU of each new task, and the photometric loss."""
    for task, (_, _, floor) in TASKS.items():
        loss_h, loss_c, worst = train_step_card_vs_cpu(dev, task=task)
        bound = '1e-4' + (f', or {floor:g} of the network\'s largest' if floor else '')
        print(f'phase 8a {task} train_step card vs cpu [2,64,96] (16,)*6: loss '
              f'{loss_c} on the card, {loss_h} on the CPU; worst gradient error '
              f'{worst["grad_vs_max"]:.3e} of its tensor\'s largest |gradient| (bound '
              f'{bound}); worst parameter error after the Adam step '
              f'{worst["param_vs_lr"]:.3e} lr (bound 1e-2); running stats within rtol 1e-4')
    print('phase 8a photometric gradient gap card vs cpu by cause (worst error over its '
          'tensor\'s largest |gradient|, zeros / border padding): '
          + '; '.join(f'{case} {gaps["zeros"]:.3e} / {gaps["border"]:.3e}'
                      for case, gaps in photometric_gap_causes(dev).items()))
    worst = photometric_card_vs_cpu(dev)
    print(f'phase 8a photometric loss card vs cpu [2,64,96], 4 scales, 2 contexts, zeros '
          f'and border padding: values within rtol 1e-5, worst gradient error {worst:.3e} '
          f'of its tensor\'s largest |gradient| (bound {PHOTOMETRIC_BOUND:g})')


def phase_train_dee(dev):
    cfg = train_config()
    cfg.model.name = 'EdgeEstimationLIDARModel'
    return train_full(dev, cfg, full_width_batch(dev), 'phase 8b DEE train')


def selfsup_config():
    """The shipped training config at supervised_loss_weight 0.9 with
    PoseNet and one back and one forward context frame."""
    cfg = train_config()
    cfg.model.loss.supervised_loss_weight = 0.9
    cfg.model.pose_net.name = 'PoseNet'
    cfg.datasets.train.back_context = cfg.datasets.train.forward_context = 1
    return cfg


def selfsup_full_batch(dev):
    """7b's batch plus two context frames (the scene shifted by 4 and -4
    pixels), their originals and KITTI intrinsics."""
    batch = full_width_batch(dev)
    batch['rgb_original'] = batch['rgb']
    batch['rgb_context'] = [torch.roll(batch['rgb'], shift, dims=2) for shift in (4, -4)]
    batch['rgb_context_original'] = batch['rgb_context']
    batch['intrinsics'] = torch.from_numpy(kitti_intrinsics(TRAIN_B, H, W)).to(dev)
    return batch


def generic_config():
    """13d's and 11f's task: 8c's config as ``GenericSelfSupModel`` on
    ``RaySurfaceResNet`` 18 + ``PoseNet``."""
    cfg = selfsup_config()
    cfg.model.name = 'GenericSelfSupModel'
    cfg.model.depth_net.name = 'RaySurfaceResNet'
    cfg.model.depth_net.version = ''
    return cfg


def generic_batch(dev):
    """8c's batch cut to ``GENERIC_B`` images."""
    return {k: [x[:GENERIC_B] for x in v] if isinstance(v, list) else v[:GENERIC_B]
            for k, v in selfsup_full_batch(dev).items()}


def phase_train_selfsup(dev):
    return train_full(dev, selfsup_config(), selfsup_full_batch(dev),
                      'phase 8c self-supervised train', warps_per_step=WARPS_PER_STEP)


def phase_train_kitti_cli(dev):
    import shutil
    shutil.rmtree(KITTI_DIR, ignore_errors=True)
    tree = os.path.join(KITTI_DIR, 'kitti')
    split = write_kitti_tree(tree, n_frames=6, h=KITTI_H, w=KITTI_W, no_gt=())
    cfg = selfsup_config()
    cfg.model.name = 'SemiSupModel'
    cfg.arch.max_epochs = 1
    cfg.edges.depth_edges_metric_log = False
    cfg.datasets.augmentation.image_shape = (KITTI_H, KITTI_W)
    cfg.datasets.train.batch_size = 2
    for mode in ('train', 'validation'):
        ds = cfg.datasets[mode]
        ds.dataset, ds.path, ds.split = ['KITTI'], [tree], [split]
    cfg.checkpoint.filepath = os.path.join(KITTI_DIR, 'checkpoints')
    yaml_path = os.path.join(KITTI_DIR, 'train.yaml')
    cfg.save_yaml(yaml_path)
    t0 = time.perf_counter()
    exp = train_edges.main([yaml_path], device=dev)
    secs = time.perf_counter() - t0
    check(len(exp.train_loader.dataset) == 4 and exp.state.step == 2,
          f'{len(exp.train_loader.dataset)} KITTI frames with context, {exp.state.step} steps')
    ckpts = sorted(f for f in os.listdir(cfg.checkpoint.filepath) if f.endswith('.ckpt'))
    check(len(ckpts) == 1, f'checkpoints written: {ckpts}')
    ckpt = load_checkpoint(os.path.join(cfg.checkpoint.filepath, ckpts[0]))
    own = {f'model.{tag}.{k}': v for tag, net in (('depth_net', exp.state.net),
                                                  ('pose_net', exp.state.pose_net))
           for k, v in net.state_dict().items()}
    check(set(own) == set(ckpt['state_dict'])
          and all(torch.equal(ckpt['state_dict'][k], v.cpu()) for k, v in own.items()),
          'the KITTI checkpoint does not hold both networks bit-equal')
    print(f'phase 8d train_edges.main SemiSupModel + PoseNet on a synthetic KITTI tree '
          f'{KITTI_H}x{KITTI_W}, 6 frames (4 with both context frames), batch 2, 1 epoch '
          f'with validation: {secs:.1f} s; wrote {ckpts[0]} with '
          f'{sum(k.startswith("model.pose_net.") for k in own)} pose-network entries, '
          f'reloads bit-equal')


def write_split(root, n, h, w, seed=0):
    """``n`` frames of a blocky scene in the GTA split format (rgb, uint16
    depth, edges and normals with their ``_001..003`` scales, uint16
    LiDAR), written with cv2 -> the split file."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    scenes = blocky_scene(rng, n, h, w, 'cpu').numpy()
    lines = []
    for i, depth in enumerate(scenes):
        f = lambda tag: os.path.join(root, f'{i:06d}_{tag}.png')
        rgb = np.clip(depth * 6 + rng.randn(h, w) * 8, 0, 255)
        cv2.imwrite(f('rgb'), np.stack([rgb] * 3, -1).astype(np.uint8))
        cv2.imwrite(f('depth'), (depth * 256).astype(np.uint16))
        lidar = np.where(rng.rand(h, w) < 0.05, depth, 0.0)
        cv2.imwrite(f('lidar'), (lidar * 256).astype(np.uint16))
        edge = cv2.Canny((depth * 255 / 30).astype(np.uint8), 20, 40)
        sx = cv2.Sobel(depth.astype(np.float64), cv2.CV_64F, 1, 0, ksize=5)
        sy = cv2.Sobel(depth.astype(np.float64), cv2.CV_64F, 0, 1, ksize=5)
        normal = ((np.arctan2(-sy, sx) * 180 / np.pi + 180) / 360 * 255).astype(np.uint8)
        for s in range(4):
            size = (w >> s, h >> s)
            cv2.imwrite(f(f'edge_00{s}'), cv2.resize(edge, size, interpolation=cv2.INTER_NEAREST))
            cv2.imwrite(f(f'normal_00{s}'), cv2.resize(normal, size))
        lines.append(f'{f("rgb")} {f("depth")} {f("edge_000")} {f("lidar")} None None '
                     f'None {f("normal_000")}\n')
    path = os.path.join(root, 'split.txt')
    with open(path, 'w') as fh:
        fh.writelines(lines)
    with open(os.path.join(root, 'val.txt'), 'w') as fh:
        fh.writelines(lines[:2])
    return path, os.path.join(root, 'val.txt')


def phase_train_cli(dev):
    import shutil
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    split, val = write_split(os.path.join(SMOKE_DIR, 'data'), 4, H, W)
    cfg = train_config()
    cfg.arch.max_epochs = 1
    cfg.datasets.train.batch_size = 2
    cfg.datasets.train.path, cfg.datasets.train.split = [''], [split]
    cfg.datasets.validation.path, cfg.datasets.validation.split = [''], [val]
    cfg.checkpoint.filepath = os.path.join(SMOKE_DIR, 'checkpoints')
    yaml_path = os.path.join(SMOKE_DIR, 'train.yaml')
    cfg.save_yaml(yaml_path)
    t0 = time.perf_counter()
    exp = train_edges.main([yaml_path], device=dev)
    secs = time.perf_counter() - t0
    ckpts = sorted(f for f in os.listdir(cfg.checkpoint.filepath) if f.endswith('.ckpt'))
    check(len(ckpts) == 1, f'checkpoints written: {ckpts}')
    path = os.path.join(cfg.checkpoint.filepath, ckpts[0])
    ckpt = load_checkpoint(path)
    own = exp.state.net.state_dict()
    check(all(torch.equal(ckpt['state_dict'][f'model.depth_net.{k}'], v.cpu())
              for k, v in own.items()) and len(own) == len(ckpt['state_dict']),
          'the checkpoint does not reload bit-equal')
    cfg2, resume = parse_train_file(yaml_path)
    check(resume == path, f'resume picked {resume}')
    state = Experiment(cfg2, resume_ckpt=resume, device=dev).initialize_state()
    steps = {int(s['step']) for s in state.optimizer.state_dict()['state'].values()}
    check(state.epoch == 1 and state.step == 2 and steps == {2},
          f'resumed at epoch {state.epoch}, step {state.step}, Adam steps {steps}')
    print(f'phase 7c train_edges.main {H}x{W}, 4 frames, batch 2, 1 epoch with '
          f'validation on 2 frames: {secs:.1f} s; wrote {ckpts[0]}, reloads bit-equal; '
          f'resume starts at epoch {state.epoch}, step {state.step}, Adam step count '
          f'{steps.pop()}')


# a fresh interpreter runs the CLI module named by its first argument as
# ``python -m`` does, then reports the NMS kernel's launches in that process
CLI_RUNNER = ("import runpy, sys\n"
              "from mindtheedge_tpu_torch.ops.cuda import nms_kernel\n"
              "module, sys.argv = sys.argv[1], sys.argv[1:]\n"
              "nms_kernel.launches = 0\n"
              "runpy.run_module(module, run_name='__main__')\n"
              "print(f'NMS launches {nms_kernel.launches}')\n")


def native_files():
    """{path: mtime} of ``native/``, where the JAX package builds its matcher
    and the port must not."""
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, names in os.walk('native') for f in names}


def eval_config(split, gt_list, edge_list, folder):
    """``configs/infer_packnet_kitti.yaml`` with its split, its GT lists and
    its output folder replaced, written next to the data -> its path."""
    import yaml
    with open(EVAL_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['datasets']['test']['split'] = [split]
    cfg['analysis']['gt_image_list'] = gt_list
    cfg['analysis']['edge_image_list'] = edge_list
    cfg['save']['folder'] = folder
    check(cfg['analysis']['run_metrics'] and cfg['analysis']['run_heavy_edge_metrics'],
          f'{EVAL_CONFIG} no longer asks for both metrics')
    path = os.path.join(EVAL_DIR, 'infer_packnet_kitti.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_eval():
    """The KITTI-DE evaluation end to end: ``infer_edges`` with the shipped
    config on a synthetic 60-frame tree, in a fresh process -> the NMS
    kernel's launches there."""
    import shutil
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    split, _ = write_split(os.path.join(EVAL_DIR, 'data'), EVAL_FRAMES, EVAL_H, EVAL_W, seed=9)
    with open(split) as f:
        rows = [ln.split(' ') for ln in f.read().splitlines()]
    lists = []
    for name, col in (('gt_depth.txt', 1), ('gt_edges.txt', 2)):
        lists.append(os.path.join(EVAL_DIR, name))
        with open(lists[-1], 'w') as f:
            f.writelines(r[col] + '\n' for r in rows)
    out_dir = os.path.join(EVAL_DIR, 'out')
    yaml_path = eval_config(split, *lists, out_dir)
    native_before = native_files()
    write_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', CLI_RUNNER,
                           'mindtheedge_tpu_torch.cli.infer_edges', '--config', yaml_path,
                           '--batch', str(B), '--wire', 'u16'],
                          capture_output=True, text=True, timeout=900)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(EVAL_DIR, 'cli.log'), 'w') as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f'infer_edges exited {proc.returncode}: '
          f'{(proc.stdout + proc.stderr)[-3000:]}')
    log = proc.stdout

    def number(pattern):
        found = re.search(pattern, log)
        check(found is not None, f'infer_edges printed no line matching {pattern!r}')
        return float(found.group(1))

    n = EVAL_FRAMES
    infer_s = number(rf'Inference of {n} frames: ([\d.]+) s')
    depth_s = number(rf'Depth metrics and D3R of {n} frames: ([\d.]+) s')
    auc_s = number(rf'Edge AUC of {n} frames at {EVAL_THRESHOLDS} thresholds, native '
                   r'matcher: ([\d.]+) s')
    d3r = number(r'D3R ordinal: ([\d.]+)')
    launches = int(number(r'NMS launches (\d+)'))
    files = os.listdir(out_dir)
    n_npy = sum(f.endswith('_regular.npy') for f in files)
    n_color = sum(f.endswith('_regular_color.png') for f in files)
    check(n_npy == n_color == EVAL_FRAMES, f'{n_npy} depth maps, {n_color} colour PNGs')
    with open(os.path.join(out_dir, 'mean_frames_depth_metrics.csv')) as f:
        lines = f.read().splitlines()
    check(lines[0] == ',0' and len(lines) == 8, f'depth metrics CSV {lines}')
    means = {k: float(v) if v else float('nan') for k, v in (ln.split(',') for ln in lines[1:])}
    check(all(np.isfinite(v) for v in means.values()), f'depth metrics {means}')
    with open(os.path.join(out_dir, 'edge_AUC.txt')) as f:
        aucs = [float(ln.split(': ')[1]) for ln in f.read().splitlines()]
    check(len(aucs) == 2 and all(0.0 <= a <= 1.0 for a in aucs), f'edge AUCs {aucs}')
    check(native_files() == native_before, 'the port wrote into native/')
    jpegs = len(os.listdir(os.path.join(out_dir, 'temp_output')))
    check(jpegs == EVAL_FRAMES, f'{jpegs} Canny JPEGs')
    print(f'phase 9 KITTI-DE evaluation, {EVAL_FRAMES} frames, GT {EVAL_H}x{EVAL_W}, inference '
          f'{H}x{W} b{B} fp32 (u16 wire) with {EVAL_CONFIG}: synthetic tree written in '
          f'{write_s:.1f} s; the CLI in a fresh process {wall_s:.1f} s wall: inference '
          f'{infer_s:.3f} s ({EVAL_FRAMES / infer_s:.2f} frames/s), depth metrics and D3R '
          f'{depth_s:.3f} s ({EVAL_FRAMES / depth_s:.2f} frames/s), edge AUC over '
          f'{EVAL_THRESHOLDS} thresholds x {EVAL_FRAMES} frames on the native matcher '
          f'{auc_s:.3f} s ({EVAL_FRAMES / auc_s:.2f} frames/s); evaluation throughput '
          f'{EVAL_FRAMES / (infer_s + depth_s + auc_s):.3f} frames/s; nms launches {launches}')
    print(f'phase 9 results (random weights): edge AUC full {aucs[0]}, partial {aucs[1]}; '
          f'D3R ordinal {d3r}; mean depth metrics '
          + ', '.join(f'{k} {v}' for k, v in means.items()))
    return launches


def rel_err_quantiles(got, want):
    """(median, p99, max) of |got - want| / want over the pixels where
    ``want`` > 0."""
    keep = want > 0
    err = ((got - want).abs()[keep] / want[keep]).double()
    return float(err.median()), float(torch.quantile(err, 0.99)), float(err.max())


def edge_agreement(got, want):
    """Of the pixels that are an edge in either map, the share that are an
    edge in both."""
    a, b = got > 0, want > 0
    return float((a & b).sum()) / max(float((a | b).sum()), 1.0)


def phase_serve_bf16(dev):
    """10a: phase 4's requests and weights, the model cast once to bf16 ->
    (NMS launches, the served map, mismatches, max |err|, mean ms)."""
    launches, prob, bad, err, model16, requests, mean_ms = phase_serve(
        dev, torch.bfloat16, SERVE_BF16_REQUESTS, 'phase 10a')
    model32 = serve.build(SLIM_CHANNELS, device=dev, seed=0)
    rgb_u8, lidar = requests[-1]
    rgb, lidar = rgb_u8.to(dev).float() / 255.0, lidar.to(dev)
    out32 = serve.depth_edges(model32, rgb, lidar)
    out16 = serve.depth_edges(model16, rgb.bfloat16(), lidar.bfloat16())
    check(out16['depth'].dtype == torch.float32 and bool(torch.isfinite(out16['depth']).all()),
          'bf16 served depth not finite fp32')
    med, p99, worst = rel_err_quantiles(out16['depth'], out32['depth'])
    agree = edge_agreement(out16['edges'], out32['edges'])
    same_px = float(((out16['edges'] > 0) == (out32['edges'] > 0)).float().mean())
    check(med < 0.05 and agree > 0.5, f'bf16 serving: depth median error {med}, edges {agree}')
    print(f'phase 10a bf16 vs fp32 on the last request: depth relative error median '
          f'{med:.3e}, p99 {p99:.3e}, max {worst:.3e} (pixels with depth > 0); edge '
          f'pixels agree on {agree:.4f} of those that are an edge in either map, all '
          f'pixels on {same_px:.5f}; {mean_ms:.3f} ms/request in bf16')
    return launches, prob, bad, err


def phase_annotate_bf16(dev):
    """10b: ``configs/annotate_edges_kitti_training_set.yaml`` plus
    ``precision: bfloat16`` -> NMS launches."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(ANNOTATE_CONFIG)
    cfg16 = cfg.clone()
    cfg16.arch.precision = 'bfloat16'
    launches, batches, results16, _ = annotate_run(
        dev, build_task(cfg16, device=dev), REQUESTS, 'phase 10b')
    rgb, lidar = batches[-1]
    results32 = annotate_batch(build_task(cfg, device=dev), rgb.to(dev), lidar.to(dev))
    agree = [edge_agreement(a['edge'], b['edge']) for a, b in zip(results16, results32)]
    check(min(agree) > 0.3, f'bf16 annotation: edges agree on {agree}')
    print(f'phase 10b bf16 vs fp32 ({ANNOTATE_CONFIG}, same weights, last batch): edge '
          f'pixels agree on ' + ', '.join(f'{a:.4f}' for a in agree)
          + ' of those that are an edge in either map (scales 0-3)')
    return launches


def phase_infer_bf16(dev):
    """10c: phase 6's network and batches in bf16 -> NMS launches."""
    cfg = task_config('SemiSupEdgeModel')
    cfg.arch.precision = 'bfloat16'
    task16 = build_task(cfg, device=dev)
    launches, (rgb, lidar), _, _ = infer_run(dev, task16, REQUESTS, 'phase 10c')
    task32 = build_task(task_config('SemiSupEdgeModel'), device=dev)
    rgb, lidar = rgb.to(dev), lidar.to(dev)
    depth16 = infer_batch(task16, rgb, lidar, 'f32')
    med, p99, worst = rel_err_quantiles(depth16, infer_batch(task32, rgb, lidar, 'f32'))
    check(depth16.dtype == torch.float32 and med < 0.05, f'bf16 inference: median error {med}')
    print(f'phase 10c bf16 vs fp32 on the last batch (dense float32 uplink): depth '
          f'relative error median {med:.3e}, p99 {p99:.3e}, max {worst:.3e}')
    return launches


def phase_train_bf16(dev, losses32):
    """10d: the shipped training config as written (bf16) on 7b's batch,
    from 7b's weights and generator seed."""
    cfg = get_cfg_defaults()
    cfg.merge_from_file(TRAIN_CONFIG)
    check(cfg.arch.precision == 'bfloat16' and not cfg.model.depth_net.remat,
          f'{TRAIN_CONFIG} is no longer bf16 without remat')
    _, _, losses16 = train_full(dev, cfg, full_width_batch(dev), 'phase 10d bf16 train',
                                conv3d_per_step=2 * CONV3D_PER_PASS)
    print('phase 10d loss by step, bf16 (as shipped) / fp32 (7b), same weights, batch '
          'and generator: ' + ', '.join(f'{a:.6f} / {b:.6f}' for a, b in zip(losses16, losses32)))


def phase_train_remat(dev, ms32, peak32):
    """10e: 7b's config and batch with ``remat`` True, then ``'conv'``;
    then one step of each from the same weights and generator against the
    step without remat."""
    batch = full_width_batch(dev)
    configs = {False: train_config()}
    for remat in (True, 'conv'):
        configs[remat] = cfg = train_config()
        cfg.model.depth_net.remat = remat
        ms, peak, _ = train_full(dev, cfg, batch, f'phase 10e remat {remat!r} train')
        print(f'phase 10e remat {remat!r}: {ms:.3f} ms/step ({ms / ms32:.3f} x 7b\'s '
              f'{ms32:.3f}), peak {peak / 2**30:.3f} GiB ({peak / peak32:.3f} x 7b\'s '
              f'{peak32 / 2**30:.3f})')
    gaps, bound, noise = remat_vs_plain(dev, configs, batch)
    print(f'phase 10e one step against the step without remat, same weights and '
          f'generator: worst (loss, gradient median / max over its tensor\'s largest, '
          f'running statistics median / max) ' + '; '.join(
              f'{r!r} {g["loss"]:.3e}, {g["grad"][0]:.3e} / {g["grad"][1]:.3e}, '
              f'{g["stats"][0]:.3e} / {g["stats"][1]:.3e}' for r, g in gaps.items())
          + f'; the same draws; bound {bound:.3e} (4 x the noise of two steps without '
          f'remat, {max(noise["loss"], *noise["grad"], *noise["stats"]):.3e}, at least '
          f'{GRAD_RTOL:g}, 7a\'s gradient tolerance)')


def phase_small_bf16_remat(dev):
    """10f: one bf16 step card vs CPU; remat against no remat on the card,
    dropout and flip on, both at [2,64,96]."""
    got, ref = bf16_card_vs_cpu(dev)
    fmt = lambda g: (f'loss {g["loss"]:.3e}, gradients {g["grad"][0]:.3e} / {g["grad"][1]:.3e}, '
                     f'running statistics {g["stats"][0]:.3e} / {g["stats"][1]:.3e}')
    print(f'phase 10f bf16 train_step card vs cpu [2,64,96] (16,)*6 (median / max): '
          f'{fmt(got)}; within {BAND:g} x the CPU\'s bf16 vs fp32: {fmt(ref)}')
    small = synthetic_batch(np.random.RandomState(0), 2, 64, 96)
    gaps, bound, noise = remat_vs_plain(
        dev, {r: remat_config(r) for r in (False, True, 'conv')}, small)
    print(f'phase 10f remat train_step on the card vs without, dropout 0.5, flip 0.5, '
          f'SemiSupEdgeCompletionModel [2,64,96]: ' + '; '.join(
              f'{r!r} {fmt(g)}' for r, g in gaps.items())
          + f'; generator state and num_batches_tracked equal; noise of two steps without '
          f'remat {fmt(noise)}; bound {bound:.3e}')


def phase_dp_nccl(dev, losses7b):
    """11a: the data-parallel step in a process group of one over NCCL ->
    the NMS kernel's launches."""
    os.makedirs(DP_DIR, exist_ok=True)
    store = os.path.abspath(os.path.join(DP_DIR, 'nccl_store'))
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group('nccl', init_method=f'file://{store}', rank=0, world_size=1)
    nms_kernel.launches = 0
    try:
        cfg, batch = train_config(), full_width_batch(dev)
        gaps, bound, noise = dp_vs_plain(dev, cfg, batch)
        ms, peak, losses = train_full(dev, cfg, batch, 'phase 11a data-parallel (NCCL, '
                                      'world 1) train', make_step=make_dp_train_step)
        _, _, again = train_full(dev, cfg, batch, 'phase 11a plain train again')
        gap = lambda run: [abs(a - b) / abs(b) for a, b in zip(run, losses7b)]
        by_step, by_step_plain = gap(losses), gap(again)
        check(max(by_step) <= RUN_RTOL,
              f'11a loss by step {by_step} against 7b beyond {RUN_RTOL} (a plain run: '
              f'{by_step_plain})')
        with torch.device('meta'):
            shapes = [p.shape for p in build_depth_net(cfg.model.depth_net).parameters()]
        grads = [torch.rand(shape, device=dev) for shape in shapes]
        all_reduce_mean(grads)
        # it holds the host until the card is idle (5 calls behind event_ms's
        # 0.5 s sleep took 0.513 s to enqueue), so event_ms's check cannot hold
        all_reduce_ms = sync_ms(lambda i: all_reduce_mean(grads), 5)
    finally:
        dist.destroy_process_group()
    numel = sum(g.numel() for g in grads)
    print(f'phase 11a loss by step against 7b (relative), data-parallel / a second plain '
          f'run: ' + ', '.join(f'{a:.3e} / {b:.3e}' for a, b in zip(by_step, by_step_plain))
          + f' (bound {RUN_RTOL:g}: the same draws, but the card\'s reductions decide '
          f'near-ties that Adam and the edge loss amplify step by step)'
          + f'; one step against the plain step, same weights and generator: loss '
          f'{gaps["loss"]:.3e}, gradients {gaps["grad"][0]:.3e} / {gaps["grad"][1]:.3e} '
          f'(median / max over its tensor\'s largest), running statistics '
          f'{gaps["stats"][0]:.3e} / {gaps["stats"][1]:.3e}; bound {bound:.3e} (4 x two '
          f'plain steps, {max(noise["loss"], *noise["grad"], *noise["stats"]):.3e}, at '
          f'least {GRAD_RTOL:g}); {ms:.3f} ms/step, peak {peak / 2**30:.3f} GiB; one '
          f'all-reduce (mean) of {numel} fp32 gradients in {len(grads)} tensors, coalesced, '
          f'{all_reduce_ms:.3f} ms by CUDA events (5 in a row)')
    return nms_kernel.launches


def launch(module, *argv):
    """Start ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` of the CLI ``module`` under :data:`CLI_RUNNER`;
    :func:`launched` waits for it."""
    runner = os.path.abspath(os.path.join(DP_DIR, 'run_cli.py'))
    with open(runner + '.tmp', 'w') as f:
        f.write(CLI_RUNNER)
    os.replace(runner + '.tmp', runner)     # another launcher may be reading it
    logs = [os.path.join(DP_DIR, module.rsplit('.', 1)[-1] + ext) for ext in ('.log', '.err')]
    with open(logs[0], 'w') as out, open(logs[1], 'w') as err:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', '1', runner, module, *argv],
            stdout=out, stderr=err, env=dict(os.environ, PYTHONPATH=os.getcwd()))
    return module, proc, time.perf_counter(), logs


def launched(started):
    """Wait for a :func:`launch` -> (its output, wall seconds, the NMS
    kernel's launches)."""
    module, proc, t0, logs = started
    try:
        proc.wait(600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall = time.perf_counter() - t0
    stdout, stderr = (open(path).read() for path in logs)
    log = stdout + stderr
    check(proc.returncode == 0, f'{module} under torch.distributed.run exited '
          f'{proc.returncode}: {log[-3000:]}')
    found = re.search(r'NMS launches (\d+)', stdout)
    check(found is not None, f'{module}: no launch count printed')
    check('Distributed: process 0 of 1, backend nccl, device cuda:0' in stdout,
          f'{module}: the process group did not come up over NCCL: {log[-3000:]}')
    return stdout, wall, int(found.group(1))


def phase_dp_clis():
    """11c and 11d, their two launchers at once (each a fresh process that
    spends most of its wall starting up) -> {'11c', '11d': NMS launches}."""
    train, infer = dp_train_cli_start(), dp_infer_cli_start()
    try:
        return {'11c': dp_train_cli_end(train), '11d': dp_infer_cli_end(infer)}
    finally:
        for _, (_, proc, _, _) in (train, infer):
            if proc.poll() is None:
                proc.terminate()
                proc.wait(60)


def dp_train_cli_start():
    """11c: ``cli.train_edges`` under the launcher on 7c's split; its
    checks in :func:`dp_train_cli_end`."""
    out = os.path.join(DP_DIR, 'train_cli')
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    cfg = train_config()
    cfg.arch.max_epochs = 1
    cfg.datasets.train.batch_size = 2
    cfg.datasets.train.path = ['']
    cfg.datasets.train.split = [os.path.join(SMOKE_DIR, 'data', 'split.txt')]
    cfg.datasets.validation.split = ['']    # 7c validates; a fresh process would autotune it
    # resized to 8c's 96x320: cuDNN's autotuner in a fresh process takes
    # about a minute at 384x1280
    cfg.datasets.augmentation.image_shape = (KITTI_H, KITTI_W)
    cfg.checkpoint.filepath = os.path.join(out, 'checkpoints')
    yaml_path = os.path.join(DP_DIR, 'train_cli.yaml')
    cfg.save_yaml(yaml_path)
    return cfg, launch('mindtheedge_tpu_torch.cli.train_edges', yaml_path)


def dp_train_cli_end(started):
    """11c's checks -> the NMS kernel's launches."""
    cfg, started = started
    _, wall, launches = launched(started)
    files = os.listdir(cfg.checkpoint.filepath)
    ckpts = [f for f in files if f.endswith('.ckpt')]
    check(len(ckpts) == 1 and 'metrics.jsonl' in files, f'11c wrote {files}')
    print(f'phase 11c torch.distributed.run --standalone --nproc_per_node 1 -m '
          f'mindtheedge_tpu_torch.cli.train_edges, 7c\'s split at {KITTI_H}x{KITTI_W} (4 '
          f'frames, batch 2, 1 epoch, no validation): group up over NCCL at world 1, '
          f'wrote {ckpts[0]} and metrics.jsonl; {wall:.1f} s wall with the launcher (beside '
          f'11d\'s); nms launches {launches}')
    return launches


def dp_infer_cli_start():
    """11d: ``cli.infer_edges --dp 1`` under the launcher on the first
    frames of phase 9's split; its checks against phase 9's files in
    :func:`dp_infer_cli_end`."""
    import yaml
    out = os.path.join(DP_DIR, 'infer_cli')
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with open(os.path.join(EVAL_DIR, 'data', 'split.txt')) as f:
        lines = f.read().splitlines()[:DP_INFER_FRAMES]
    split = os.path.join(out, 'split.txt')
    with open(split, 'w') as f:
        f.writelines(ln + '\n' for ln in lines)
    with open(EVAL_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['datasets']['test']['split'] = [split]
    cfg['save']['folder'] = os.path.join(out, 'out')
    cfg['analysis']['run_metrics'] = cfg['analysis']['run_heavy_edge_metrics'] = False
    yaml_path = os.path.join(out, 'infer.yaml')
    with open(yaml_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return out, launch('mindtheedge_tpu_torch.cli.infer_edges', '--config', yaml_path,
                       '--batch', str(B), '--dp', '1', '--wire', 'u16')


def dp_infer_cli_end(started):
    """11d's checks -> the NMS kernel's launches."""
    out, started = started
    _, wall, launches = launched(started)
    worst = 0.0
    for i in range(DP_INFER_FRAMES):
        name = f'{i:08d}_regular.npy'
        got = np.load(os.path.join(out, 'out', name))
        want = np.load(os.path.join(EVAL_DIR, 'out', name))
        worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= 1.0 / 256 + 1e-6, f'11d depth {worst} m off phase 9\'s, over one u16 code')
    print(f'phase 11d torch.distributed.run --standalone --nproc_per_node 1 -m '
          f'mindtheedge_tpu_torch.cli.infer_edges --dp 1 --wire u16, {DP_INFER_FRAMES} '
          f'frames of phase 9: worst depth difference to phase 9\'s files {worst:.6f} m '
          f'({worst * 256:.3f} u16 codes, bound 1); {wall:.1f} s wall with the launcher '
          f'(beside 11c\'s); nms launches {launches}')
    return launches


def phase_spatial_nccl(dev):
    """12a: the sharded code path with a space of one over NCCL at world 1
    against the unsharded forward -> (the NMS kernel's launches, the
    request, the unsharded inverse depths on the CPU)."""
    os.makedirs(SPATIAL_DIR, exist_ok=True)
    store = os.path.abspath(os.path.join(SPATIAL_DIR, 'nccl_store'))
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group('nccl', init_method=f'file://{store}', rank=0, world_size=1)
    nms_kernel.launches = 0
    try:
        rgb_u8, lidar = serve_requests(1)[0]
        rgb, lidar = rgb_u8.to(dev).float() / 255.0, lidar.to(dev)
        plain = serve.build(SLIM_CHANNELS, device=dev, seed=0)
        space = spatial.Space(1)
        infer = spatial.make_spatial_infer(serve.build(SLIM_CHANNELS, device=dev, seed=0),
                                           space, with_depth=True)
        with torch.no_grad():
            want = plain(rgb, lidar)['inv_depths']
            got = infer(rgb, lidar)         # the first call autotunes its shapes
            space.counts = dict.fromkeys(space.counts, 0)
            got = infer(rgb, lidar)
            counts = dict(space.counts)
            err = forward_gap(got, want)
            runs = {'plain': [], 'sharded': []}
            for kind in ('plain', 'sharded', 'sharded', 'plain'):
                fn = (lambda i: plain(rgb, lidar)) if kind == 'plain' else \
                    (lambda i: infer(rgb, lidar))
                runs[kind].append(sync_ms(fn, SPATIAL_ITERS))
    finally:
        dist.destroy_process_group()
    print(f'phase 12a sharded path with a space of one (NCCL, world 1), {H}x{W} b{B} fp32 '
          f'LiDAR: 4 scales within rtol 1e-4 atol 1e-5 of serve.build\'s forward (max |err| '
          f'{err:.3e}); one forward runs {counts["exchange"]} halo exchanges (zero pads here) '
          f'and {counts["statistics"]} reductions (none at one block); ms by CUDA events over '
          f'{SPATIAL_ITERS} forwards, in turn plain / sharded / sharded / plain: '
          + ' / '.join(f'{m:.3f}' for m in (runs['plain'][0], *runs['sharded'], runs['plain'][1]))
          + f' (sharded / plain {np.mean(runs["sharded"]) / np.mean(runs["plain"]):.3f}); '
          f'nms launches {nms_kernel.launches}')
    return nms_kernel.launches, {'rgb': rgb.cpu(), 'lidar': lidar.cpu()}, \
        [d.cpu() for d in want]


def ddad_argv(name, spatial_arg, precision='float32'):
    """``cli.infer_edges`` argv of :data:`DDAD_CONFIG` on the synthetic
    DDAD split in :data:`SPATIAL_DIR`, its output in ``name``, at
    ``arch.precision`` ``precision``."""
    import yaml
    with open(DDAD_CONFIG) as f:
        cfg = yaml.safe_load(f)
    cfg['datasets']['test']['split'] = [os.path.join(SPATIAL_DIR, 'ddad', 'split.txt')]
    cfg['datasets']['augmentation']['image_shape'] = list(DDAD_SHAPE)
    cfg['save']['folder'] = os.path.join(SPATIAL_DIR, name)
    cfg['analysis']['run_heavy_edge_metrics'] = False
    cfg.setdefault('arch', {})['precision'] = precision
    path = os.path.join(SPATIAL_DIR, f'{name}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return ['--config', path, '--batch', str(DDAD_FRAMES), '--spatial', spatial_arg,
            '--wire', 'f32']


def ddad_maps(name):
    return [np.load(os.path.join(SPATIAL_DIR, name, f'{i:08d}_regular.npy'))
            for i in range(DDAD_FRAMES)]


def within_card_band(what, got, gap):
    """``got`` (median, max) within ``BAND`` times the card's own
    bf16-vs-fp32 ``gap`` (median, max) on the same inputs."""
    for name, g, j in zip(('median', 'max'), got, gap):
        check(g <= BAND * j, f'{what} {name}: {g:.3e} > {BAND} x the card\'s bf16-vs-fp32 '
              f'{j:.3e}')


def step_band(got, want16, want32):
    """A sharded bf16 step's outcome (``timed_outcome``) against the
    unsharded bf16 step's and the fp32 one's (``step_outcome``) -> (gaps of
    the sharded step, the card's bf16-vs-fp32 gaps): loss, gradients and
    running statistics, each held within ``BAND`` times the card's own."""
    stats = lambda d: {k: v for k, v in d.items() if k.endswith(('running_mean', 'running_var'))}
    gap = {'loss': abs(want16[0] - want32[0]) / abs(want32[0]),
           'grad': tensor_errs(want16[1], want32[1], want32[1]),
           'stats': tensor_errs(stats(want16[2]), stats(want32[2]), stats(want32[2]))}
    out = {'loss': abs(got['loss'] - want16[0]) / abs(want16[0]),
           'grad': tensor_errs(got['grads'], want16[1], want32[1]),
           'stats': tensor_errs(stats(got['state']), stats(want16[2]), stats(want32[2]))}
    print(f'12b bf16 readings, the sharded step against the unsharded bf16 one (the card\'s '
          f'bf16-vs-fp32 gaps in brackets): loss {out["loss"]:.3e} [{gap["loss"]:.3e}], '
          f'gradients median / max {out["grad"][0]:.3e} / {out["grad"][1]:.3e} '
          f'[{gap["grad"][0]:.3e} / {gap["grad"][1]:.3e}], running statistics '
          f'{out["stats"][0]:.3e} / {out["stats"][1]:.3e} [{gap["stats"][0]:.3e} / '
          f'{gap["stats"][1]:.3e}]; band {BAND:g}x', flush=True)
    check(out['loss'] <= BAND * gap['loss'], f'12b bf16 loss {out["loss"]:.3e} > {BAND} x '
          f'{gap["loss"]:.3e}')
    within_card_band('12b bf16 gradients', out['grad'], gap['grad'])
    within_card_band('12b bf16 running statistics', out['stats'], gap['stats'])
    return out, gap


def phase_rank_pair(dev, request, want):
    """13a's L4 check, 11b, 11e, 11f, 12b and 12c, fp32 and bf16: one pair
    of spawned ranks over gloo sharing the card runs every job, their
    oracles computed on the card in this process while the ranks start ->
    {path: NMS launches}."""
    import shutil
    for name in ('ddad', 'ddad_plain', 'ddad_spatial', 'ddad_plain16', 'ddad_spatial16'):
        shutil.rmtree(os.path.join(SPATIAL_DIR, name), ignore_errors=True)
    os.makedirs(DP_DIR, exist_ok=True)
    dp_config = os.path.join(DP_DIR, 'train_fp32.yaml')
    train_config().save_yaml(dp_config)
    cfg = train_config()
    cfg.model.loss.flip_lr_prob = 0.0
    config = os.path.join(SPATIAL_DIR, 'train_fp32_flip0.yaml')
    cfg.save_yaml(config)
    cfg16 = train_config()
    cfg16.model.loss.flip_lr_prob = 0.0
    cfg16.arch.precision = 'bfloat16'
    config16 = os.path.join(SPATIAL_DIR, 'train_bf16_flip0.yaml')
    cfg16.save_yaml(config16)
    gcfg = generic_config()
    generic_yaml = os.path.join(DP_DIR, 'generic.yaml')
    gcfg.save_yaml(generic_yaml)
    batch = full_width_batch(dev)
    batch4 = full_width_batch(dev, seed=4, b=SHARDED_B)
    gbatch = {k: [x.cpu() for x in v] if isinstance(v, list) else v.cpu()
              for k, v in generic_batch(dev).items()}
    paths = {k: os.path.join(SPATIAL_DIR, f'{k}.pt')
             for k in ('batch', 'batch4', 'request', 'generic')}
    torch.save({k: v.cpu() for k, v in batch.items()}, paths['batch'])
    torch.save({k: v.cpu() for k, v in batch4.items()}, paths['batch4'])
    torch.save(request, paths['request'])
    torch.save(gbatch, paths['generic'])
    write_split(os.path.join(SPATIAL_DIR, 'ddad'), DDAD_FRAMES, DDAD_H, DDAD_W, seed=12)

    # the oracles: the unsharded CLIs alone on the card (their wall seconds
    # are compared), then the steps and the bf16 forward while the ranks
    # start up
    nms_kernel.launches = 0
    plain_cli_s = {}
    for precision, name in (('float32', 'ddad_plain'), ('bfloat16', 'ddad_plain16')):
        t0 = time.perf_counter()
        infer_edges.main(ddad_argv(name, '0', precision), device=dev)
        plain_cli_s[precision] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    jobs = {'13a L4': (generic_step_job, {'device': 'cuda:0'}),
            'gloo bf16': (gloo_dtype_job, {'device': 'cuda:0'}),
            '11b': (oracle_job, {'device': 'cuda:0', 'full_config': dp_config,
                                 'full_batch': paths['batch']}),
            '12b': (card_pair_job, {'full_config': config, 'full_batch': paths['batch'],
                                    'full_forward': paths['request']}),
            '12c': (cli_job, {'argv': ddad_argv('ddad_spatial', '2'), 'device': 'cuda:0'}),
            '12b bf16': (card_pair_job, {'full_config': config16, 'full_batch': paths['batch'],
                                         'full_forward': paths['request'],
                                         'dtype': torch.bfloat16}),
            '12c bf16': (cli_job, {'argv': ddad_argv('ddad_spatial16', '2', 'bfloat16'),
                                   'device': 'cuda:0'}),
            '11e': (sharded_step_job, {'config': config, 'batch': paths['batch4'],
                                       'device': 'cuda:0', 'timed_steps': SHARDED_STEPS,
                                       'oracle': True}),
            '11f': (sharded_step_job, {'config': generic_yaml, 'batch': paths['generic'],
                                       'device': 'cuda:0',
                                       'timed_steps': GENERIC_SHARDED_STEPS})}
    ranks = start_ranks(list(jobs.values()), 2, os.path.join(SPATIAL_DIR, 'gloo'),
                        threads=max(os.cpu_count() // 2, 1), wait_s=PAIR_WAIT_S,
                        cudnn_benchmark_limit=PAIR_CUDNN_LIMIT)
    try:
        plain_step = step_outcome(cfg, batch, dev)
        plain_step16 = step_outcome(cfg16, batch, dev)
        plain_generic = timed_outcome(gcfg, gbatch, make_train_step, dev)
        net16 = serve.build(device=dev, seed=0, dtype=torch.bfloat16)
        with torch.no_grad():
            want16 = [d.float().cpu() for d in net16(
                request['rgb'].to(dev, torch.bfloat16),
                request['lidar'].to(dev, torch.bfloat16))['inv_depths']]
        del net16, batch, batch4, gbatch
        plain_launches = nms_kernel.launches
        torch.cuda.empty_cache()
    finally:
        ranks.join()
    res = {name: ranks.result(i) for i, name in enumerate(jobs)}
    ranks_s = time.perf_counter() - t0
    job_s = {name: max(ranks.seconds(i)) for i, name in enumerate(jobs)}

    print('phase 12b gloo collectives with bf16 tensors on the card (rank 0): '
          + ', '.join(f'{k} {v}' for k, v in res['gloo bf16'][0].items()))
    results = res['11b']
    gaps = oracle_gaps(results)
    print(f'phase 11b 2 ranks over gloo on one card, [2 per rank,64,96] (16,)*6: one '
          f'data-parallel step against rank 0\'s oracle (the mean of both ranks\' plain '
          f'steps on the card): loss {gaps["loss"]:.3e}, worst gradient '
          f'{gaps["grad"]:.3e} of its tensor\'s largest (bound {GRAD_RTOL:g}), running '
          f'statistics {gaps["stats"]:.3e} (rtol 1e-4); both ranks\' parameters and '
          f'buffers bit-equal')
    for r, out in enumerate(results):
        full = out['full']
        check(all(np.isfinite(full['losses'])), f'11b rank {r} losses {full["losses"]}')
        print(f'phase 11b rank {r}, full width {H}x{W} b{TRAIN_B} fp32, '
              f'{full["parameters"]} parameters, gloo through the host (no NCCL speed '
              f'figure), both ranks on one card: {len(full["ms"])} steps after 1 warm-up, '
              + ', '.join(f'{m:.3f}' for m in full['ms'])
              + f' ms by CUDA events, peak {full["peak"] / 2**30:.3f} GiB; one gradient '
              f'all-reduce alone {full["all_reduce_ms"]:.3f} ms (host clock); losses '
              + ', '.join(f'{v:.6f}' for v in full['losses']))

    for r, gaps in enumerate(res['13a L4']):
        print(f'phase 13a L4 in pair rank {r} (a fresh process, {PAIR_CUDNN_LIMIT} cuDNN '
              f'candidates a conv): GenericSelfSupModel train_step card vs cpu [2,64,96]: the '
              f'card\'s gradients against the cpu\'s fp64 over the cpu fp32\'s (card_64 / '
              f'cpu_64, bound {GENERIC_STEP_BAND}x) '
              + ', '.join(f'{tag} {g["card_64"]:.5f} / {g["cpu_64"]:.5f} = '
                          f'{g["card_64"] / g["cpu_64"]:.3f}' for tag, g in gaps['step'].items())
              + '; backward ' + ', '.join(f'{tag} {e:.3e}' for tag, e in gaps['backward'].items())
              + f' (bound {GRAD_RTOL:g})')

    gaps = generic_sharded_gaps(res['11f'], plain_generic)
    for r, out in enumerate(res['11f']):
        check(all(np.isfinite(out['losses'])), f'11f rank {r} losses {out["losses"]}')
        print(f'phase 11f rank {r} of 2 over gloo on one card, make_sharded_train_step, '
              f'GenericSelfSupModel (RaySurfaceResNet 18 + PoseNet, 13d\'s config) {H}x{W} '
              f'global b{GENERIC_B} (1 a rank) fp32: one step against the plain card step on '
              f'the global batch (taken in this process): loss {gaps["loss"]:.3e} (rtol 1e-4), '
              f'BatchNorm2d running statistics at {gaps["stats"]:.3f} of their tolerance (rtol 1e-4, '
              f'atol 1e-6), '
              f'gradients by relative L2 '
              + ', '.join(f'{tag} {gaps[tag]:.4f}' for tag in ('depth', 'pose'))
              + f' (bound {GENERIC_SHARDED_L2:g})'
              + f'; both ranks\' parameters and statistics bit-equal; {len(out["ms"])} steps '
              'after it: ' + ', '.join(f'{m:.3f}' for m in out['ms'])
              + f' ms by CUDA events, peak {out["peak"] / 2**30:.3f} GiB a rank; losses '
              + ', '.join(f'{v:.6f}' for v in out['losses']))

    sharded_oracle = res['11e'][0]['oracle']
    sharded_oracle = (sharded_oracle['loss'], sharded_oracle['grads'], sharded_oracle['state'])
    for r, out in enumerate(res['11e']):
        gaps = step_gaps(out, sharded_oracle)
        check(all(np.isfinite(out['losses'])), f'11e rank {r} losses {out["losses"]}')
        print(f'phase 11e rank {r} of 2 over gloo on one card, make_sharded_train_step, '
              f'7b\'s config (flip 0) {H}x{W} global b{SHARDED_B} ({SHARDED_B // 2} a rank) '
              f'fp32: one step against the plain card step on the global batch: loss '
              f'{gaps["loss"]:.3e} (rtol 1e-5), gradients {gaps["grad"]:.3e} of their largest '
              f'(bound {GRAD_RTOL:g}), running statistics at {gaps["stats"]:.3f} of their '
              f'tolerance (the plain step taken alone by rank 0); {len(out["ms"])} steps after it: '
              + ', '.join(f'{m:.3f}' for m in out['ms'])
              + f' ms by CUDA events, peak {out["peak"] / 2**30:.3f} GiB a rank; losses '
              + ', '.join(f'{v:.6f}' for v in out['losses']))

    for tag, plain, fwd_want in (('', plain_step, want), (' bf16', plain_step16, want16)):
        for r, out in enumerate(res['12b' + tag]):
            step = out['full_step']
            check(all(np.isfinite(step['losses'])), f'12b{tag} rank {r} losses {step["losses"]}')
            fwd = out['forward_ms']
            if tag:
                gap = rel_err_quantiles(torch.cat([d.flatten() for d in want16]),
                                        torch.cat([d.flatten() for d in want]))[::2]
                err = rel_err_quantiles(torch.cat([d.flatten() for d in out['full_forward']]),
                                        torch.cat([d.flatten() for d in want16]))[::2]
                within_card_band('12b bf16 forward inv_depths', err, gap)
                fwd_text = (f'relative error of the 4 scales\' inv_depths against the unsharded '
                            f'bf16 forward median {err[0]:.3e} / max {err[1]:.3e}, the card\'s '
                            f'bf16 vs fp32 {gap[0]:.3e} / {gap[1]:.3e} (bound {BAND:g}x)')
                sgaps, sgap = step_band(step, plain_step16, plain_step)
                step_text = (f'loss {sgaps["loss"]:.3e}, gradients {sgaps["grad"][0]:.3e} / '
                             f'{sgaps["grad"][1]:.3e}, running statistics '
                             f'{sgaps["stats"][0]:.3e} / {sgaps["stats"][1]:.3e} (median / max '
                             f'of each tensor\'s worst over its largest) against the unsharded '
                             f'bf16 step; the card\'s bf16 vs fp32 {sgap["loss"]:.3e}, '
                             f'{sgap["grad"][0]:.3e} / {sgap["grad"][1]:.3e}, '
                             f'{sgap["stats"][0]:.3e} / {sgap["stats"][1]:.3e} (bound {BAND:g}x)')
            else:
                fwd_text = (f'max |err| {forward_gap(out["full_forward"], fwd_want):.3e} against '
                            f'the unsharded card forward (rtol 1e-4, atol 1e-5)')
                full = step_gaps(step, plain)
                step_text = (f'loss {full["loss"]:.3e} (rtol 1e-5), gradients '
                             f'{full["grad"]:.3e} of their largest (bound {GRAD_RTOL:g}), running '
                             f'statistics at {full["stats"]:.3f} of their tolerance (rtol 1e-4, '
                             f'atol 1e-6) against the plain card step')
            print(f'phase 12b{tag} rank {r} of 2 over gloo on one card, H over 2, full width '
                  f'{H}x{W} b{B} forward: {fwd_text}; {fwd["forward"]:.3f} ms a forward by '
                  f'CUDA events, peak {fwd["peak"] / 2**30:.3f} GiB (both ranks on one card, '
                  f'gloo through the host); one forward runs '
                  f'{out["forward_counts"]["exchange"]} halo exchanges, '
                  f'{out["forward_counts"]["statistics"]} statistic reductions; one halo '
                  f'exchange of [4,32,192,1280] by 3 rows alone {fwd["exchange_32ch_p3"]:.3f} '
                  f'ms (host clock)')
            print(f'phase 12b{tag} rank {r}, 7b\'s config (flip 0) {H}x{W} b{TRAIN_B}: one '
                  f'spatial step: {step_text}; {len(step["ms"])} steps after it: '
                  + ', '.join(f'{m:.3f}' for m in step['ms'])
                  + f' ms by CUDA events, peak {step["peak"] / 2**30:.3f} GiB a rank (7b: one '
                  f'process, the whole frame); losses '
                  + ', '.join(f'{v:.6f}' for v in step['losses']))

    for tag, spatial_dir, plain_dir, precision in (
            ('', 'ddad_spatial', 'ddad_plain', 'float32'),
            (' bf16', 'ddad_spatial16', 'ddad_plain16', 'bfloat16')):
        got, plain_maps = ddad_maps(spatial_dir), ddad_maps(plain_dir)
        for m in got:
            check(m.shape == DDAD_SHAPE, f'12c{tag} depth map {m.shape}')
        if tag:
            flat = lambda maps: torch.from_numpy(np.stack(maps)).flatten()
            err = rel_err_quantiles(flat(got), flat(plain_maps))[::2]
            gap = rel_err_quantiles(flat(plain_maps), flat(ddad_maps('ddad_plain')))[::2]
            within_card_band('12c bf16 depth', err, gap)
            text = (f'depth relative error against the unsharded bf16 CLI median {err[0]:.3e} '
                    f'/ max {err[1]:.3e}, the unsharded CLI\'s bf16 vs fp32 {gap[0]:.3e} / '
                    f'{gap[1]:.3e} (bound {BAND:g}x)')
        else:
            for i, (g, p) in enumerate(zip(got, plain_maps)):
                np.testing.assert_allclose(g, p, rtol=1e-4, atol=1e-5, err_msg=f'frame {i}')
            worst = max(float(np.abs(g - p).max()) for g, p in zip(got, plain_maps))
            text = (f'depth within rtol 1e-4 atol 1e-5 of the unsharded CLI on the card (max '
                    f'|err| {worst:.3e} m)')
        cli = res['12c' + tag]
        print(f'phase 12c{tag} infer_edges --spatial 2 --wire f32 at {precision} on 2 gloo ranks '
              f'sharing the card, {DDAD_FRAMES} frames {DDAD_H}x{DDAD_W} resized to '
              f'{DDAD_SHAPE[0]}x{DDAD_SHAPE[1]} ({DDAD_CONFIG}\'s model): {text}; wall '
              + ', '.join(f'rank {r} {c["seconds"]:.1f} s' for r, c in enumerate(cli))
              + f', the unsharded CLI {plain_cli_s[precision]:.1f} s (one process); nms '
              f'launches ' + ', '.join(str(c['nms_launches']) for c in cli))
    print(f'phase 13a L4, 11b, 11e, 11f, 12b and 12c (fp32 and bf16): {len(jobs)} jobs on one '
          f'pair of ranks, {ranks_s:.1f} s from spawn to end (cuDNN\'s autotuner timing '
          f'{PAIR_CUDNN_LIMIT} candidates a conv), the slower rank\'s seconds by job: '
          + ', '.join(f'{k} {v:.1f}' for k, v in job_s.items())
          + f'; the unsharded oracles\' NMS launches {plain_launches}')
    sharded_gns = {name: [out['gn_elu_launches'] for out in res[name]]
                   for name in ('12b', '12c', '12b bf16', '12c bf16')}
    print(f'phase 12b-c GroupNorm + ELU kernel launches in the sharded ranks: {sharded_gns}')
    check(all(n == 0 for v in sharded_gns.values() for n in v),
          f'the GroupNorm + ELU kernel launched in the sharded ranks: {sharded_gns}')
    check(plain_launches == 0, f'NMS kernel launched {plain_launches} times in the oracles')
    return {name: sum(out['nms_launches'] for out in outs) for name, outs in res.items()
            if name != 'gloo bf16'}


def generic_sharded_gaps(results, plain):
    """11f's ranks (``sharded_step_job``) against the plain card step on the
    global batch (``timed_outcome``) and each other -> the loss's relative
    error, the BatchNorm2d running statistics' worst error over their
    tolerance (rtol 1e-4, atol 1e-6), each
    network's gradient error by relative L2; each held (see
    ``GENERIC_SHARDED_L2``)."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        check(res['loss'] == first['loss'], f'11f rank {r} loss {res["loss"]} != {first["loss"]}')
        for k, v in first['state'].items():
            check(torch.equal(res['state'][k], v), f'11f rank {r} {k} differs from rank 0')
    loss = abs(first['loss'] - plain['loss']) / abs(plain['loss'])
    check(loss <= 1e-4, f'11f loss {first["loss"]} against {plain["loss"]}')
    stats = [k for k in plain['state'] if k.endswith(('running_mean', 'running_var'))]
    check(bool(stats), '11f: no running statistics')
    worst = 0.0
    for k in stats:
        got, want = first['state'][k].double(), plain['state'][k].double()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: f'11f {k}: {m}')
        worst = max(worst, float(((got - want).abs() / (1e-6 + 1e-4 * want.abs())).max()))
    out = {'loss': loss, 'stats': worst}
    for tag, key in (('depth', 'grads'), ('pose', 'pose_grads')):
        flat = lambda d: torch.cat([d[n].double().reshape(-1) for n in sorted(plain[key])])
        out[tag] = float((flat(first[key]) - flat(plain[key])).norm() / flat(plain[key]).norm())
        check(out[tag] <= GENERIC_SHARDED_L2,
              f'11f {tag} gradients {out[tag]} from the plain step\'s, bound '
              f'{GENERIC_SHARDED_L2}')
    return out


def phase_variants_small(dev):
    """13a: the new networks and tasks card vs CPU at [2,64,96], and the
    card's GroupNorm against fp64 (ROADMAP L2)."""
    for name in EVAL_CASES:
        err = eval_card_vs_cpu(dev, name)
        print(f'phase 13a {name} eval card vs cpu [2,64,96] (16,)*6: 4 scales within rtol '
              f'1e-4 atol 1e-5, max |err| {err:.3e}')
    loss_h, loss_c, worst = train_step_card_vs_cpu(dev, spec=PACKNET01_SELFSUP)
    print(f'phase 13a SelfSupModel + PoseNet on PackNet01 train_step card vs cpu [2,64,96] '
          f'(16,)*6: loss {loss_c} on the card, {loss_h} on the CPU; worst gradient error '
          f'{worst["grad_vs_max"]:.3e} of its tensor\'s largest |gradient| (bound 1e-4, or '
          f'{PACKNET01_SELFSUP[2]:g} of the network\'s largest); worst parameter error after '
          f'the Adam step {worst["param_vs_lr"]:.3e} lr (bound 1e-2)')
    logits_err = patch_logits_card_vs_cpu(dev)
    warp_err = camera_generic_card_vs_fp64(dev)
    print(f'phase 13a camera_generic on the card: the patch logits and their backward against '
          f'the CPU within {logits_err:.3e} of their largest (bound 1e-5); '
          f'view_synthesis_generic on pinhole rays [2,32,48] against the CPU in fp64: worst '
          f'gradient error {warp_err:.3e} of its tensor\'s largest (bound 1e-3)')
    gaps = generic_step_card_vs_cpu(dev)
    print('phase 13a GenericSelfSupModel (RaySurfaceResNet 18 + PoseNet) at progress 0.5, '
          'card vs cpu [2,64,96]: one train_step\'s loss and metrics within rtol 1e-4; the '
          'networks\' backward from seeded cotangents: worst gradient error '
          + ', '.join(f'{tag} {err:.3e}' for tag, err in gaps['backward'].items())
          + f' of its tensor\'s largest (bound {GRAD_RTOL:g}); the step\'s gradients '
          '(ill-conditioned in fp32: near-ties of the soft argmax, coordinates on pixel centres), '
          'relative L2 (of the cpu fp64 gradient\'s norm) card vs cpu / the cpu\'s fp32 vs its '
          f'fp64 / the card vs the cpu\'s fp64 (bound {GENERIC_STEP_BAND}x the cpu\'s) / a second '
          'card step vs the first (ROADMAP L4): '
          + ', '.join(f'{tag} ' + ' / '.join(f'{g[k]:.3e}' for k in ('card_cpu', 'cpu_64',
                                                                     'card_64', 'card_card'))
                      for tag, g in gaps['step'].items())
          + '; card_64 / cpu_64 ' + ', '.join(f'{tag} {g["card_64"] / g["cpu_64"]:.3f}'
                                               for tag, g in gaps['step'].items()))
    l2 = group_norm_fp64_gaps(dev)
    print('phase 13a L2: the seeded (16,)*6 PackNet-SAN 1A on blocky frames [4,128,128] on '
          'the card, largest relative error against its fp64 forward at scales 0-3: '
          'F.group_norm ' + ', '.join(f'{e:.3e}' for e in l2['plain'])
          + '; two-pass statistics ' + ', '.join(f'{e:.3e}' for e in l2['two_pass']))
    check(max(l2['two_pass']) <= 3e-5, f'13a two-pass GroupNorm off fp64 by {l2["two_pass"]}')


def edge_split(root):
    """``EDGE_FRAMES`` KITTI-size frames of ``write_split`` with a .npy
    ``rgb_edge`` map [H,W] in [0.2, 1] in the 6th column -> the split."""
    split, _ = write_split(root, EDGE_FRAMES, EVAL_H, EVAL_W, seed=13)
    rng = np.random.RandomState(13)
    lines = []
    with open(split) as f:
        for i, line in enumerate(f.read().splitlines()):
            parts = line.split(' ')
            parts[5] = os.path.join(root, f'{i:06d}_rgb_edge.npy')
            np.save(parts[5], rng.uniform(0.2, 1.0, (H, W)).astype(np.float32))
            lines.append(' '.join(parts) + '\n')
    with open(split, 'w') as f:
        f.writelines(lines)
    return split


def phase_rgb_edge_cli(dev):
    """13b: ``cli.infer_edges --wire f32`` of the 4-channel SLIM PackNet-SAN
    1A with LiDAR in a fresh process, against the network called directly
    on the card -> the NMS kernel's launches (in the CLI and here)."""
    import shutil
    import yaml
    root = os.path.join(VARIANTS_DIR, 'rgb_edge')
    shutil.rmtree(root, ignore_errors=True)
    split = edge_split(os.path.join(root, 'data'))
    cfg = {'model': {'name': 'SemiSupEdgeModel',
                     'depth_net': {'name': 'PackNetSAN01', 'version': '1A',
                                   'input_channels': 4}},
           'datasets': {'augmentation': {'image_shape': [H, W]},
                        'test': {'dataset': ['GTA'], 'path': [''], 'split': [split],
                                 'input_depth_type': ['lidar'],
                                 'depth_type': ['groundtruth']}},
           'save': {'folder': os.path.join(root, 'out')},
           'checkpoint': {'filepath': os.path.join(root, 'missing.ckpt')},
           'analysis': {'run_metrics': False, 'run_heavy_edge_metrics': False}}
    yaml_path = os.path.join(root, 'infer.yaml')
    with open(yaml_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', CLI_RUNNER,
                           'mindtheedge_tpu_torch.cli.infer_edges', '--config', yaml_path,
                           '--batch', str(B), '--wire', 'f32'],
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(root, 'cli.log'), 'w') as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f'13b infer_edges exited {proc.returncode}: '
          f'{(proc.stdout + proc.stderr)[-3000:]}')
    infer_s = float(re.search(rf'Inference of {EDGE_FRAMES} frames: ([\d.]+) s',
                              proc.stdout).group(1))
    cli_launches = int(re.search(r'NMS launches (\d+)', proc.stdout).group(1))

    conf = get_cfg_defaults()
    conf.merge_from_file(yaml_path)
    task = build_task(conf, device=dev)
    with open(split) as f:
        lines = f.read().splitlines()
    nms_kernel.launches = 0
    worst, batches = 0.0, []
    for i in range(0, EDGE_FRAMES, B):
        rgb, lidar, edge = (torch.from_numpy(np.stack(a)).to(dev) for a in zip(
            *[infer_edges._read_inputs(ln, conf, (H, W)) for ln in lines[i:i + B]]))
        batches.append((rgb, lidar, edge))
        with torch.no_grad():
            depth = inv2depth(task.infer({'rgb': rgb, 'input_depth': lidar, 'rgb_edge': edge})
                              ['inv_depths'][0][..., 0]).cpu().numpy()
        for b, d in enumerate(depth):
            got = np.load(os.path.join(root, 'out', f'{i + b:08d}_regular.npy'))
            check(got.shape == (H, W) and np.isfinite(got).all(), f'13b depth map {got.shape}')
            np.testing.assert_allclose(got, d, rtol=1e-4, atol=1e-5, err_msg=f'13b frame {i + b}')
            worst = max(worst, float(np.abs(got - d).max()))
    rgb, lidar, edge = batches[0]
    with torch.no_grad():
        forward_ms = sync_ms(lambda i: task.infer(
            {'rgb': rgb, 'input_depth': lidar, 'rgb_edge': edge}), 5)
    print(f'phase 13b infer_edges --wire f32, PackNet-SAN 1A SLIM input_channels 4 with '
          f'LiDAR, {EDGE_FRAMES} frames {EVAL_H}x{EVAL_W} resized to {H}x{W} with a .npy '
          f'rgb_edge column, b{B} fp32, in a fresh process: every depth map within rtol 1e-4 '
          f'atol 1e-5 of the network called directly on the card (max |err| {worst:.3e} m); '
          f'the CLI {wall_s:.1f} s wall, its inference {infer_s:.3f} s '
          f'({1e3 * infer_s / (EDGE_FRAMES // B):.1f} ms per batch, cuDNN\'s autotuner '
          f'included); the direct forward {forward_ms:.3f} ms per batch by CUDA events; nms '
          f'launches {cli_launches} in the CLI, {nms_kernel.launches} here')
    return cli_launches + nms_kernel.launches


def phase_packnet01_train(dev):
    """13c: 8c's config (SelfSupModel here) on PackNet01 at FULL_CHANNELS."""
    cfg = selfsup_config()
    cfg.model.name = 'SelfSupModel'
    cfg.model.depth_net.name = 'PackNet01'
    cfg.model.depth_net.channels = ()
    return train_full(dev, cfg, selfsup_full_batch(dev),
                      'phase 13c SelfSupModel + PoseNet on PackNet01 FULL_CHANNELS train',
                      warmup=2, steps=3, warps_per_step=WARPS_PER_STEP)


def phase_generic_train(dev):
    """13d: GenericSelfSupModel (RaySurfaceResNet 18 + PoseNet) on 8c's
    batch cut to 2 images, and ``project_generic``'s time in one step."""
    cfg, batch = generic_config(), generic_batch(dev)
    out = train_full(dev, cfg, batch, 'phase 13d GenericSelfSupModel train', warmup=1, steps=3)
    task = build_task(cfg, device=dev)
    state = create_train_state(cfg, to_train_device(task.depth_net, dev), pose_net=task.pose_net)
    step = make_train_step(task)
    gen = torch.Generator(dev).manual_seed(cfg.arch.seed)
    step(state, batch, gen)
    plain = camera_generic.project_generic
    calls = []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        coords = plain(*args, **kwargs)
        end.record()
        calls.append((start, end, tuple(args[0].shape)))
        return coords

    camera_generic.project_generic = timed
    try:
        begin, finish = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        step(state, batch, gen)
        finish.record()
        finish.synchronize()
    finally:
        camera_generic.project_generic = plain
    step_ms = begin.elapsed_time(finish)
    proj_ms = sum(a.elapsed_time(b) for a, b, _ in calls)
    print(f'phase 13d project_generic in one step: {len(calls)} calls (2 contexts x 4 scales, '
          f'shapes {sorted({c[2] for c in calls})}), forward {proj_ms:.3f} ms by CUDA events '
          f'around each call, of a {step_ms:.3f} ms step ({100 * proj_ms / step_ms:.1f} %; '
          'its backward runs in the step\'s backward and is not in this figure)')
    return out


def phase_canny(dev):
    """14: ``ops/canny.canny_sweep`` of KITTI-size images on the card
    against the CPU (``tests/test_torch_canny_cuda.canny_card_vs_cpu``)."""
    out = canny_card_vs_cpu(dev, CANNY_SHAPE)
    print(f'phase 14 canny_sweep {list(CANNY_SHAPE)} uint8-range noisy blocky scenes, '
          f'{len(CANNY_SWEEP)} thresholds (t/2, t), t = {CANNY_SWEEP[0]}..{CANNY_SWEEP[-1]}: '
          f'{out["agree"]:.6f} of pixels agree with the CPU (bound 0.9999); '
          f'{out["ms"]:.3f} ms a sweep by CUDA events (mean of 3 after a warm-up), '
          f'{out["steps"]} dilation steps, {out["checks"]} host checks; edge pixels by '
          f'threshold ' + ', '.join(str(n) for n in out['edges']))


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(), 'nvidia-smi failed')
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    print(f'torch {torch.__version__} cuda {torch.version.cuda} on '
          f'{torch.cuda.get_device_name(0)}')
    walls, convs, warps, gns = {}, {}, {}, {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        conv3d_kernel.launches = warp_kernel.launches = gn_elu_kernel.launches = 0
        out = fn(*args)
        convs[name] = conv3d_kernel.launches
        warps[name] = warp_kernel.launches
        gns[name] = gn_elu_kernel.launches
        walls[name] = time.perf_counter() - t
        return out

    timed('1', phase_build)
    px2, bad2, err2 = timed('2', phase_kernel_vs_plain, dev)
    timed('3', phase_small_slice, dev)
    launches4, prob, bad4, err4, *_ = timed('4', phase_serve, dev)
    kernel_ms, plain_ms, bound_ms, bound_by = timed('nms timing', time_nms, prob)
    checked3d, worst3d, conv3d_ms, conv3d_plain_ms, conv3d_bound, conv3d_by, conv3d_shape_ms = \
        timed('conv3d', phase_conv3d, dev)
    warp_shapes, warp_worst, warp_ms, warp_plain_ms, warp_bound = timed('warp', phase_warp, dev)
    gn_shapes, gn_worst, gn_ms, gn_plain_ms, gn_bound = timed('gn_elu', phase_gn_elu, dev)
    launches5, px5, bad5, err5 = timed('5', phase_annotate, dev, kernel_ms)
    launches6 = timed('6', phase_infer, dev)
    nms_kernel.launches = 0
    timed('7a', phase_train_small, dev)
    ms7b, peak7b, losses7b = timed('7b', phase_train_full, dev)
    timed('7c', phase_train_cli, dev)
    launches7 = nms_kernel.launches
    check(launches7 == 0, f'NMS kernel launched {launches7} times on the training path')
    launches8 = 0
    for name, fn in (('8a', phase_train_small_tasks), ('8b', phase_train_dee),
                     ('8c', phase_train_selfsup), ('8d', phase_train_kitti_cli)):
        nms_kernel.launches = 0
        timed(name, fn, dev)
        check(nms_kernel.launches == 0,
              f'NMS kernel launched {nms_kernel.launches} times in phase {name}')
        launches8 += nms_kernel.launches
    print(f'NMS launches on the phase-8 training paths (DEE, completion, '
          f'self-supervised): {launches8}')
    launches9 = timed('9', phase_eval)
    check(launches9 == 0, f'NMS kernel launched {launches9} times on the evaluation path')
    launches10a, prob10, bad10, err10 = timed('10a', phase_serve_bf16, dev)
    launches10b = timed('10b', phase_annotate_bf16, dev)
    launches10c = timed('10c', phase_infer_bf16, dev)
    check(launches10c == 0, f'NMS kernel launched {launches10c} times on the bf16 inference path')
    launches10 = {}
    for name, fn, args in (('10d', phase_train_bf16, (dev, losses7b)),
                           ('10e', phase_train_remat, (dev, ms7b, peak7b)),
                           ('10f', phase_small_bf16_remat, (dev,))):
        nms_kernel.launches = 0
        timed(name, fn, *args)
        launches10[name] = nms_kernel.launches
        check(launches10[name] == 0,
              f'NMS kernel launched {launches10[name]} times in phase {name}')
    t11 = time.perf_counter()
    launches11 = {'11a': timed('11a', phase_dp_nccl, dev, losses7b)}
    launches11.update(timed('11c+11d', phase_dp_clis))
    launches12 = {}
    launches12['12a'], request, want12 = timed('12a', phase_spatial_nccl, dev)
    pair = timed('11b+11e+12b-c', phase_rank_pair, dev, request, want12)
    launches11.update({k: v for k, v in pair.items() if k.startswith('11')})
    launches12.update({k: v for k, v in pair.items() if k.startswith('12')})
    check(pair['13a L4'] == 0, f'NMS kernel launched {pair["13a L4"]} times in the L4 jobs')
    for name, n in list(launches11.items()) + list(launches12.items()):
        check(n == 0, f'NMS kernel launched {n} times in phase {name}')
    print(f'phases 11 and 12 wall time {time.perf_counter() - t11:.1f} s')
    t13 = time.perf_counter()
    launches13 = {}
    for name, fn in (('13a', phase_variants_small), ('13b', phase_rgb_edge_cli),
                     ('13c', phase_packnet01_train), ('13d', phase_generic_train)):
        nms_kernel.launches = 0
        out = timed(name, fn, dev)
        launches13[name] = out if name == '13b' else nms_kernel.launches
        check(launches13[name] == 0,
              f'NMS kernel launched {launches13[name]} times in phase {name}')
    print(f'phase 13 wall time {time.perf_counter() - t13:.1f} s')
    nms_kernel.launches = 0
    timed('14', phase_canny, dev)
    launches14 = nms_kernel.launches
    check(launches14 == 0, f'NMS kernel launched {launches14} times in phase 14')
    for name in ('4', '5', '6', '10a', '10b', '10c'):
        check(warps[name] == 0, f'warp kernel launched {warps[name]} times in phase {name}')
    for name in ('4', 'conv3d', 'warp', '7b', '8c', '13c'):
        check(gns[name] == 0, f'GroupNorm + ELU kernel launched {gns[name]} times in fp32 '
                              f'phase {name}')
    print('phase wall times (s): ' + ', '.join(f'{k} {v:.1f}' for k, v in walls.items()))
    print(f'chip_smoke wall time {time.perf_counter() - t0:.1f} s')
    card = card_line()
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'nms_sobel5', 'route': 'cuda',
        'source': 'mindtheedge_tpu_torch/csrc/nms_kernel.cu',
        'replaces': 'mindtheedge_tpu/ops/pallas/nms_kernel.py:111',
        'launches': (launches4 + launches5 + launches6 + launches7 + launches8 + launches9
                     + launches10a + launches10b + launches10c + sum(launches10.values())
                     + sum(launches11.values()) + sum(launches12.values())
                     + sum(launches13.values()) + pair['13a L4'] + launches14),
        'launches_by_path': {'serve': launches4, 'annotate': launches5,
                             'infer': launches6, 'train': launches7,
                             'train_dee_completion_selfsup': launches8,
                             'eval': launches9, 'serve_bf16': launches10a,
                             'annotate_bf16': launches10b, 'infer_bf16': launches10c,
                             'train_bf16': launches10['10d'],
                             'train_remat': launches10['10e'],
                             'train_dp_nccl': launches11['11a'],
                             'train_dp_gloo2': launches11['11b'],
                             'train_dp_cli': launches11['11c'],
                             'infer_dp_cli': launches11['11d'],
                             'train_sharded_gloo2': launches11['11e'],
                             'train_sharded_resnet_gloo2': launches11['11f'],
                             'spatial_infer_nccl1': launches12['12a'],
                             'spatial_train_gloo2': launches12['12b'],
                             'spatial_infer_cli_gloo2': launches12['12c'],
                             'spatial_train_bf16_gloo2': launches12['12b bf16'],
                             'spatial_infer_cli_bf16_gloo2': launches12['12c bf16'],
                             'variants_card_vs_cpu': launches13['13a'],
                             'infer_rgb_edge_cli': launches13['13b'],
                             'train_packnet01': launches13['13c'],
                             'train_generic': launches13['13d'],
                             'canny_sweep': launches14},
        'max_abs_err': max(err2, err4, err5, err10),
        'mismatched_px': bad2 + bad4 + bad5 + bad10,
        'checked_px': px2 + prob.numel() + px5 + prob10.numel(),
        'tolerance': 'agree on >= 99.99% of pixels, kept values bit-equal',
        'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': None}, {
        'name': 'conv3d_over_channels', 'route': 'cuda',
        'source': 'mindtheedge_tpu_torch/csrc/conv3d_kernel.cu',
        'replaces': None, 'in_place_of': "cuDNN's generic 3-D conv (F.conv3d)",
        'launches': sum(convs.values()),
        'launches_in_process_by_phase': convs,
        'max_err_over_tolerance': worst3d, 'checked_elements': checked3d,
        'tolerance': 'fp32 rtol 1e-5 atol 1e-6 of F.conv3d; bf16 1 ulp of the fp32 '
                     'conv of the same operands plus the fp32 sums\' rounding',
        'ms': conv3d_ms, 'plain_ms': conv3d_plain_ms, 'bound_ms': conv3d_bound,
        'bound_by': conv3d_by, 'bf16_shape_ms': conv3d_shape_ms,
        'layouts': {'bf16': 'NCHW in and out', 'bf16_nhwc': 'channels-last in and out, '
                    'the bf16 networks\' layout'},
        'library_ms': conv3d_plain_ms}, {
        'name': 'warp_geometry', 'route': 'cuda',
        'source': 'mindtheedge_tpu_torch/csrc/warp_kernel.cu',
        'replaces': None,
        'in_place_of': 'camera.reconstruct + camera.project (ATen ops and cuBLAS 3x3 bmm)',
        'launches': sum(warps.values()),
        'launches_in_process_by_phase': warps,
        'launches_a_step': {'train_selfsup': WARPS_PER_STEP, 'train_packnet01': WARPS_PER_STEP,
                            'train_san': 0, 'train_dee': 0, 'train_bf16': 0,
                            'train_remat': 0, 'train_generic': 0},
        'max_err_over_tolerance': warp_worst, 'checked_shapes': warp_shapes,
        'tolerance': 'coords and depth gradient per element, pose gradient per frame: '
                     'at most 2 x the plain fp32 chain\'s error against its fp64, or 1e-5',
        'ms': warp_ms, 'plain_ms': warp_plain_ms, 'bound_ms': warp_bound,
        'bound_by': 'bytes', 'library_ms': None}, {
        'name': 'groupnorm_elu_nhwc', 'route': 'cuda',
        'source': 'mindtheedge_tpu_torch/csrc/gn_elu_kernel.cu',
        'replaces': None,
        'in_place_of': "ATen's GroupNorm (NCHW) + ELU on the bf16 path, and the layout "
                       "copies around it",
        'launches': sum(gns.values()),
        'launches_in_process_by_phase': gns,
        'launches_a_pass': {'bf16_unsharded': GN_PER_PASS, 'fp32': 0, 'sharded': 0},
        'max_err_over_tolerance': gn_worst, 'checked_shapes': gn_shapes,
        'tolerance': 'y within 0.5 bf16 ulp + 1e-5 (1 + |z|) of fp64; dx, dweight, dbias '
                     'within 1 bf16 ulp + 1e-4 of the largest of fp64; closer to fp64 than '
                     'ATen, within 5 % relative L2 of it',
        'ms': gn_ms, 'plain_ms': gn_plain_ms, 'bound_ms': gn_bound,
        'bound_by': 'bytes', 'ms_are': f'the {GN_PER_PASS} GroupNorms of a PackNet01 FULL '
                                      f'pass at {list(GN_SHAPE)}',
        'library_ms': gn_plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
