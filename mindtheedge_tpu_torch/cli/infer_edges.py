"""Batched depth inference over a split file, on one card or data-parallel
on several, then the evaluation on the host.

Counterpart of ``mindtheedge_tpu/cli/infer_edges.py``::

    python -m mindtheedge_tpu_torch.cli.infer_edges --config <yaml> \\
        [--batch 4] [--wire {u16,u8,f32}]
    torchrun --nproc_per_node N -m mindtheedge_tpu_torch.cli.infer_edges \\
        --config <yaml> --batch 4 [--dp N]
    torchrun --nproc_per_node D*N*M -m mindtheedge_tpu_torch.cli.infer_edges \\
        --config <yaml> --batch 4 --spatial {N | -1 | NxM} [--dp D]

Outputs, as there (reference ``infer_edges.py:349-366``): per image
``{idx:08d}_regular.npy`` (metric depth), ``_regular.png`` (depth/max*255),
``_regular_color.png`` (log-depth Spectral colour map, ``utils/colormap``),
and ``pred_list.txt``.  ``infer_batch`` is the device work of one batch: the
sparse LiDAR uplink is scattered to the dense map, the network runs, and the
depth leaves the card in the ``--wire`` format.  Uploads and read-backs are
pipelined two batches deep through pinned host buffers, so the host never
waits for the batch the card is running.

Then ``run_post_metrics`` (``infer_edges.py:405-442``): with
``analysis.run_metrics``, the depth metrics (``mean_frames_depth_metrics.csv``,
``sfm_analysis/<out_file_name>``) and D3R; with
``analysis.run_heavy_edge_metrics``, the edge AUC (``edge_AUC.txt``, the
Canny JPEGs in ``temp_output/``, the PR plot where matplotlib exists).

``--dp N`` (``infer_edges.py:262-273, 303-314``) runs over the N processes
of a ``torchrun`` launch, one card each; ``--batch`` is the global batch,
which N must divide, and ``--dp -1`` (the default) means the number of
processes.  Rank r infers the r-th contiguous ``batch / N`` frames of each
global batch and writes their files under their split index; after a
barrier, rank 0 writes ``pred_list.txt`` in split order and runs the
metrics.  ``--dp N`` without a group of N processes exits before any work.

``--spatial`` (``infer_edges.py:227-305``) cuts every frame into N row
blocks (``NxM``: N rows by M columns; ``-1``: the most rows
``parallel/spatial.max_space_devices`` allows over the processes), one
block a process, halo-exchanged (``parallel/spatial.py``); with ``--dp
D`` the launch holds D x N x M processes, data-major.  A size or grid
that does not keep every block even through the 5 pack levels exits with
the legal ones, and a launch of another size exits naming the one it
needs, both before any work.  Each process reads its data replica's
frames, feeds its block, and gathers the depth map over the replica; the
replica's first block writes.  The LiDAR goes up dense whatever the
``--wire``, and every frame must have the first one's shape
(``infer_edges.py:336-337, 350-360``).  The card is used unless ``main``
is given ``device='cpu'``.
"""

import argparse
import os
import time

import numpy as np
import torch

from mindtheedge_tpu_torch.config import get_cfg_defaults, parse_test_file, prepare_config
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.ops import wire
from mindtheedge_tpu_torch.parallel import spatial
from mindtheedge_tpu_torch.parallel.distributed import (
    barrier, is_main_process, maybe_initialize_distributed, rank, world_size)
from mindtheedge_tpu_torch.utils.colormap import spectral_u8
from mindtheedge_tpu_torch.utils.depth import inv2depth

_ENCODERS = {'u16': wire.encode_depth_u16, 'u8': wire.encode_depth_u8,
             'f32': lambda d: d}
_DECODERS = {'u16': wire.decode_depth_u16, 'u8': wire.decode_depth_u8,
             'f32': lambda d: d}
LAG = 2     # batches in flight before the host reads one back


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='PackNet-SAN inference')
    parser.add_argument('--config', type=str, required=True,
                        help='Input config (.yaml)')
    parser.add_argument('--batch', type=int, default=4,
                        help='Inference batch size (device batching)')
    parser.add_argument('--spatial', type=str, default='0',
                        help='Spatial sharding with halo exchange: N = H over '
                             'N processes, NxM = an H x W grid, -1 = the '
                             'largest legal H split; 0/1 = off')
    parser.add_argument('--dp', type=int, default=-1,
                        help='Data-parallel replicas, one a device (or one a '
                             'spatial grid), under torchrun --nproc_per_node: '
                             'each takes its share of every --batch.  -1 = the '
                             'processes the grid leaves, 0/1 = one replica')
    parser.add_argument('--wire', choices=('u16', 'u8', 'f32'), default='u16',
                        help='Depth downlink format: u16 = KITTI 1/256 m '
                             'storage format; u8 = the edge-AUC protocol\'s '
                             '80/255 m grid (eval-only); f32 = lossless.  '
                             'With u16 or u8 the LiDAR goes up as sparse '
                             '(idx, u16) points when density allows.')
    return parser.parse_args(argv)


def _space_grid(args, height, width):
    """The (n_h, n_w) grid ``--spatial`` asks for on frames of ``height`` x
    ``width``; exits with the legal ones for an illegal size or grid
    (``infer_edges.py:233-256``)."""
    arg = (args.spatial or '0').strip().lower()
    if arg in ('0', '1', '1x1'):
        return 1, 1
    if 'x' in arg:
        n_h, n_w = (int(t) for t in arg.split('x'))
        grids = spatial.legal_space_grids(height, width)
        if (n_h, n_w) not in grids:
            raise SystemExit(
                f'--spatial {n_h}x{n_w} is illegal for {height}x{width}: each '
                'per-shard extent must divide its dim and stay even through 5 '
                f'pack levels. Legal grids: {sorted(grids)}.')
        return n_h, n_w
    n = int(arg)
    if n < 0:
        limit = world_size() // max(args.dp, 1)
        return spatial.max_space_devices(height, limit=max(limit, 1)), 1
    legal = spatial.legal_space_sizes(height)
    if n not in legal:
        raise SystemExit(
            f'--spatial {n} is illegal for image height {height}: the per-shard '
            'height must divide H and stay even through 5 pack levels. Legal '
            f'mesh sizes for H={height}: {legal} (2-D grids: --spatial NxM).')
    return n, 1


def _dp_processes(args, n_space=1):
    """The data-parallel replica count ``--dp`` asks for, each of
    ``n_space`` processes; exits before any work where the replicas' and
    the grid's processes are not the process group's."""
    world = world_size()
    n_dp = max(world // n_space, 1) if args.dp < 0 else max(args.dp, 1)
    if args.batch % n_dp:
        raise SystemExit(f'--dp {n_dp} must divide --batch {args.batch}')
    if n_dp * n_space != world:
        what = f'--dp {n_dp}' + (f' x --spatial {n_space}' if n_space > 1 else '')
        raise SystemExit(
            f'{what} needs {n_dp * n_space} processes, one a device, and {world} '
            f'run: launch with torchrun --nproc_per_node {n_dp * n_space} -m '
            'mindtheedge_tpu_torch.cli.infer_edges')
    return n_dp


def _read_inputs(line, config, image_shape):
    """Host-side preprocessing for one split line (``infer_edges.py:54-110``)
    -> (rgb, lidar or None, rgb_edge or None).  A 4-channel network reads
    the line's 6th column as its ``rgb_edge`` [H,W,1]: a ``.npy`` map, or
    an image's channel 0 / 255, as stored (not resized)."""
    from mindtheedge_tpu_torch.data.augmentations import (
        resize_depth_preserve, resize_image)
    from mindtheedge_tpu_torch.data.readers import (
        GTA_K, load_image, process_lidar, read_lidar, read_npz_depth,
        read_png_depth)

    parts = line.strip().split(' ')
    rgb = load_image(parts[0])
    original_shape = rgb.size
    if image_shape:
        rgb = resize_image(rgb, image_shape)
    crop_shape = tuple(config.datasets.augmentation.crop_eval_borders or ())
    if len(crop_shape) == 2:
        # center-bottom crop (infer_edges.py:275-280)
        cw, ch = rgb.size
        sx = int((cw - crop_shape[1]) / 2)
        sy = int(ch - crop_shape[0])
        rgb = rgb.crop((sx, sy, sx + crop_shape[1], sy + crop_shape[0]))
    rgb_np = np.asarray(rgb, dtype=np.float32) / 255.0

    lidar_np = None
    if config.datasets.test.input_depth_type[0] != '' and len(parts) > 3 \
            and parts[3] not in ('', 'None'):
        lp = parts[3]
        ext = lp.rsplit('.', 1)[-1]
        if ext == 'png':
            lidar = read_png_depth(lp)
            lidar[lidar < 0] = 0.0
        elif ext == 'npz':
            lidar = read_npz_depth(lp, 'velodyne')
            lidar[lidar < 0] = 0.0
        elif ext == 'bin':
            if config.datasets.test.dataset[0] == 'KITTI':
                rows = np.fromfile(lp, dtype=np.float32).reshape(-1, 4).astype('int')
                lidar = np.zeros(original_shape)
                lidar[rows[:, 1], rows[:, 0]] = rows[:, 2]
            else:
                lidar = process_lidar(read_lidar(lp), GTA_K)
        else:
            lidar = None
        if lidar is not None:
            lidar = resize_depth_preserve(lidar, image_shape)
            lidar_np = lidar.astype(np.float32)

    edge_np = None
    if config.model.depth_net.input_channels == 4 and len(parts) > 5 \
            and parts[5] not in ('', 'None'):
        if parts[5].endswith('.npy'):
            edge_np = np.load(parts[5]).astype(np.float32)
        else:
            import cv2
            edge_np = cv2.imread(parts[5])[:, :, 0].astype(np.float32) / 255.0
        if edge_np.ndim == 2:
            edge_np = edge_np[:, :, None]
    return rgb_np, lidar_np, edge_np


def save_depth_outputs(pred_depth, out_base):
    """Save npy/png/color outputs (reference ``infer_edges.py:349-366``)."""
    import cv2
    pred = np.asarray(pred_depth)
    cv2.imwrite(out_base + '_regular.png',
                (pred / max(pred.max(), 1e-12)) * 255)
    # always written: pred_list.txt points at it (infer_edges.py:113-123)
    np.save(out_base + '_regular.npy', pred)
    # log-depth Spectral colour map
    from PIL import Image
    depth_log = np.log(np.clip(pred, 1e-12, None))
    depth_log = depth_log - depth_log.min()
    depth_log = depth_log / max(depth_log.max(), 1e-12)
    Image.fromarray(spectral_u8(depth_log)).save(out_base + '_regular_color.png')


@torch.no_grad()
def infer_batch(task, rgb, lidar=None, wire_format='u16', space=None, rgb_edge=None):
    """The device work of one batch (``infer_edges.py:218-225``).

    ``rgb`` [B,H,W,3] in [0, 1] on the task's device; ``lidar`` None, a
    dense [B,H,W,1] map in metres, or an (idx [B,cap], val [B,cap] uint16)
    pair from ``wire.encode_lidar_sparse``, scattered to the dense map here;
    ``rgb_edge`` None or [B,H,W,1], the 4-channel network's 4th input.
    Returns the depth of scale 0 [B,H,W] in ``wire_format``.  Under
    ``space`` (``spatial.shard_network`` applied to the task's network)
    the network runs on this rank's block of the frames (of ``rgb_edge``
    too, which multiplies the block's inverse depth), and the depth is
    gathered over the replica before it is encoded.
    """
    if isinstance(lidar, tuple):
        lidar = wire.decode_lidar_sparse(*lidar, rgb.shape[1], rgb.shape[2])
    batch = {'rgb': rgb}
    if lidar is not None:
        batch['input_depth'] = lidar
    if rgb_edge is not None:
        batch['rgb_edge'] = rgb_edge
    if space is not None:
        batch = {k: spatial.shard_spatial(v, space) for k, v in batch.items()}
    depth = inv2depth(task.infer(batch)['inv_depths'][0])
    if space is not None:
        depth = spatial.gather_spatial(depth, space)
    return _ENCODERS[wire_format](depth[..., 0])


def upload(array, device):
    """Host numpy -> device tensor; on CUDA through a pinned buffer, without
    waiting for the card."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def start_readback(t):
    """Queue the copy of device tensor ``t`` to a pinned host buffer ->
    (host tensor, event that completes with the copy, or None on the CPU)."""
    if t.device.type != 'cuda':
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def main(argv=None, device=None):
    args = parse_args(argv)
    maybe_initialize_distributed(device)
    cfg = get_cfg_defaults()
    cfg.merge_from_file(args.config)
    cfg = prepare_config(cfg)
    ckpt = None
    ckpt_path = cfg.checkpoint.filepath
    if ckpt_path and os.path.isfile(ckpt_path):
        cfg, ckpt = parse_test_file(ckpt_path, args.config)
    else:
        print(f'WARNING: checkpoint {ckpt_path!r} not found — random init '
              '(smoke/benchmark mode)')
    image_shape = tuple(cfg.datasets.augmentation.image_shape) or None
    with open(cfg.datasets.test.split[0]) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    first_shape = None
    if (args.spatial or '0').strip().lower() not in ('0', '1', '1x1'):
        first_shape = _read_inputs(lines[0], cfg, image_shape)[0].shape[:2]
    n_h, n_w = _space_grid(args, *first_shape) if first_shape else (1, 1)
    n_dp = _dp_processes(args, n_h * n_w)

    task = build_task(cfg, device, ckpt)
    dev = task.device
    space, replica, writer = None, rank(), True
    if n_h * n_w > 1:
        space = spatial.Space(n_h if n_h > 1 else None, n_w if n_w > 1 else None)
        spatial.shard_network(task.depth_net, space)
        replica, writer = space.data, space.h == space.w == 0
        print(f'Spatial: {n_dp} x {n_h} x {n_w} (data x space x space_w), '
              f'{first_shape[0]}x{first_shape[1]} halo-exchanged')
    elif first_shape:
        print(f'--spatial {args.spatial}: the largest legal split of H={first_shape[0]} '
              f'over {world_size()} process(es) is 1, so the frames run unsharded')
    os.makedirs(cfg.save.folder, exist_ok=True)

    # sparse LiDAR uplink capacity: 12.5 % of pixels (KITTI LiDAR is ~5 %);
    # a batch with a frame over it goes up dense (infer_edges.py:329-337);
    # a spatial run ships it dense
    sparse_cap = None
    if args.wire in ('u16', 'u8') and image_shape and space is None:
        sparse_cap = (image_shape[0] * image_shape[1]) // 8
    decode = _DECODERS[args.wire]

    out_base = lambda i: os.path.join(cfg.save.folder, str(i).zfill(8))
    counter = 0
    t0 = time.perf_counter()

    def drain(entry):
        nonlocal counter
        (host, done), ids = entry
        if done is not None:
            done.synchronize()
        depth = decode(host).numpy()
        for b, i in enumerate(ids):
            if writer:
                save_depth_outputs(depth[b], out_base(i))
            counter += 1

    # this replica's frames: its contiguous share of each global batch
    share = args.batch // n_dp
    first = replica * share
    in_flight = []
    for i in range(0, len(lines), args.batch):
        ids = range(i + first, min(i + first + share, len(lines)))
        if not ids:
            continue
        inputs = [_read_inputs(lines[j], cfg, image_shape) for j in ids]
        for j, (r, _, _) in zip(ids, inputs):
            if space is not None and r.shape[:2] != first_shape:
                raise SystemExit(
                    f'--spatial needs a uniform image shape: split line '
                    f'{lines[j].split(" ")[0]!r} has {r.shape[0]}x{r.shape[1]} but the '
                    f'grid was sized for {first_shape[0]}x{first_shape[1]}. Set '
                    'datasets.augmentation.image_shape to resize uniformly.')
        # pad the tail chunk to keep one batch shape
        inputs += [inputs[-1]] * (share - len(inputs))
        rgb = upload(np.stack([r for r, _, _ in inputs]), dev)
        edge = None if inputs[0][2] is None else upload(np.stack([e for _, _, e in inputs]), dev)
        lidar = None
        if inputs[0][1] is not None:
            sparse = None
            if sparse_cap:
                try:
                    sparse = [wire.encode_lidar_sparse(l, sparse_cap)
                              for _, l, _ in inputs]
                except ValueError:
                    sparse = None   # too dense for the wire: ship dense
            if sparse is not None:
                # indices < H*W <= 2^31: the int32 view keeps their values
                lidar = (upload(np.stack([s[0] for s in sparse]).view(np.int32), dev),
                         upload(np.stack([s[1] for s in sparse]), dev))
            else:
                lidar = upload(np.stack([l for _, l, _ in inputs]), dev)
        depth = infer_batch(task, rgb, lidar, args.wire, space, edge)
        in_flight.append((start_readback(depth), ids))
        if len(in_flight) > LAG:
            drain(in_flight.pop(0))
            print(f'Processed {counter}/{len(lines)}')
    for entry in in_flight:
        drain(entry)
    print(f'Processed {counter}/{len(lines)}')
    print(f'Inference of {counter} frames: {time.perf_counter() - t0:.3f} s')

    barrier()      # every rank's files are written
    if not is_main_process():
        return
    pred_files = [out_base(i) + '_regular.npy' for i in range(len(lines))]
    with open(os.path.join(cfg.save.folder, 'pred_list.txt'), 'w') as f:
        f.writelines(p + '\n' for p in pred_files)

    run_post_metrics(cfg, pred_files)
    print('-> Done!')


def run_post_metrics(cfg, pred_files):
    """The depth metrics and D3R, then the edge AUC, on the host, as the
    config asks (``infer_edges.py:405-442``); each part prints its wall
    time."""
    an = cfg.analysis
    if an.run_metrics and an.gt_image_list:
        from mindtheedge_tpu_torch.evaluation.d3r import d3r_metric
        from mindtheedge_tpu_torch.evaluation.depth_analyzer import (
            DensePredictionAnalyzer, DepthEvalLoader, run_analysis, write_mean_csv)
        t0 = time.perf_counter()
        pred_list_path = os.path.join(cfg.save.folder, 'pred_list.txt')
        image_list = an.gt_image_list   # images only used for shape/debug
        loader = DepthEvalLoader(image_list, an.gt_image_list, pred_list_path)
        analyzer = DensePredictionAnalyzer(an)
        rows = run_analysis(loader, analyzer, cfg)
        csv_path = os.path.join(cfg.save.folder, 'mean_frames_depth_metrics.csv')
        write_mean_csv(rows, csv_path)
        print(f'Depth metrics -> {csv_path}')
        scores = []
        for i in range(len(loader)):
            _, gt, d = loader[i]
            scores.append(d3r_metric(gt, d))
        print(f'D3R ordinal: {np.mean(scores):.4f}')
        print(f'Depth metrics and D3R of {len(loader)} frames: '
              f'{time.perf_counter() - t0:.3f} s')

    if an.run_heavy_edge_metrics and an.edge_image_list:
        from mindtheedge_tpu_torch.evaluation.edge_auc import edge_auc
        t0 = time.perf_counter()
        with open(an.edge_image_list) as f:
            gt_list = f.read().splitlines()
        result = edge_auc(gt_list, pred_files,
                          prec_range=(an.prec_recall_eval_range_min,
                                      an.prec_recall_eval_range_max),
                          gt_crop=an.gt_crop,
                          min_depth=an.min_depth, max_depth=an.max_depth,
                          save_folder=os.path.join(cfg.save.folder, 'temp_output'))
        auc_path = os.path.join(cfg.save.folder, 'edge_AUC.txt')
        with open(auc_path, 'w') as f:
            f.write(f"AUC over all range: {result['auc_full']}\n")
            f.write(f"AUC over partial range: {result['auc_partial']}\n")
        print(f"Edge AUC full={result['auc_full']:.4f} "
              f"partial={result['auc_partial']:.4f} -> {auc_path}")
        print(f"Edge AUC of {len(pred_files)} frames at "
              f"{len(result['precision'])} thresholds, {result['matcher']} "
              f'matcher: {time.perf_counter() - t0:.3f} s')
        plot_edge_graph(result['precision'], result['recall'],
                        os.path.join(cfg.save.folder, 'edge_pr_curve.png'))


def plot_edge_graph(precision, recall, save_file_path):
    """PR-curve plot (``infer_edges.py:445-462``, reference
    ``infer_edges.py:218-234``); skipped where matplotlib is absent."""
    try:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(15, 10))
        ax.plot(precision, recall, marker='o')
        ax.set_xlabel('precision')
        ax.set_ylabel('recall')
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.grid(True)
        fig.savefig(save_file_path)
        plt.close(fig)
    except Exception as e:
        print(f'PR plot skipped: {e}')


if __name__ == '__main__':
    main()
