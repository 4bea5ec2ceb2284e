"""Batched depth inference over a split file, on one card.

Counterpart of ``mindtheedge_tpu/cli/infer_edges.py``::

    python -m mindtheedge_tpu_torch.cli.infer_edges --config <yaml> \\
        [--batch 4] [--wire {u16,u8,f32}]

Outputs, as there (reference ``infer_edges.py:349-366``): per image
``{idx:08d}_regular.npy`` (metric depth), ``_regular.png`` (depth/max*255),
``_regular_color.png`` (log-depth Spectral colour map), and
``pred_list.txt``.  ``infer_batch`` is the device work of one batch: the
sparse LiDAR uplink is scattered to the dense map, the network runs, and the
depth leaves the card in the ``--wire`` format.  Uploads and read-backs are
pipelined two batches deep through pinned host buffers, so the host never
waits for the batch the card is running.

Not ported here: the depth and edge-AUC metrics (``analysis.run_metrics``,
``analysis.run_heavy_edge_metrics``; ROADMAP Slice D) and multi-device
serving (``--spatial``, ``--dp``; Slice E).  Asking for either exits before
any work.  The card is used unless ``main`` is given ``device='cpu'``.
"""

import argparse
import os

import numpy as np
import torch

from mindtheedge_tpu_torch.config import get_cfg_defaults, parse_test_file, prepare_config
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.ops import wire
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
                        help='Spatial sharding over devices: not ported '
                             '(ROADMAP Slice E); only 0 / 1 are accepted')
    parser.add_argument('--dp', type=int, default=-1,
                        help='Data-parallel devices: not ported (ROADMAP '
                             'Slice E); only -1 / 0 / 1 are accepted')
    parser.add_argument('--wire', choices=('u16', 'u8', 'f32'), default='u16',
                        help='Depth downlink format: u16 = KITTI 1/256 m '
                             'storage format; u8 = the edge-AUC protocol\'s '
                             '80/255 m grid (eval-only); f32 = lossless.  '
                             'With u16 or u8 the LiDAR goes up as sparse '
                             '(idx, u16) points when density allows.')
    return parser.parse_args(argv)


def _refuse_unported(args, cfg):
    """Exit before any work where the run asks for what is not ported."""
    if (args.spatial or '0').strip().lower() not in ('0', '1', '1x1') \
            or args.dp > 1:
        raise SystemExit('--spatial / --dp (multi-device serving) are not '
                         'ported yet: ROADMAP Slice E')
    if cfg.analysis.run_metrics or cfg.analysis.run_heavy_edge_metrics:
        raise SystemExit('analysis.run_metrics / run_heavy_edge_metrics '
                         '(depth and edge-AUC metrics) are not ported yet: '
                         'ROADMAP Slice D; set both to False')


def _read_inputs(line, config, image_shape):
    """Host-side preprocessing for one split line (``infer_edges.py:54-110``
    without the 4-channel ``rgb_edge`` input) -> (rgb, lidar or None)."""
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
    return rgb_np, lidar_np


def save_depth_outputs(pred_depth, out_base):
    """Save npy/png/color outputs (reference ``infer_edges.py:349-366``)."""
    import cv2
    pred = np.asarray(pred_depth)
    cv2.imwrite(out_base + '_regular.png',
                (pred / max(pred.max(), 1e-12)) * 255)
    # always written: pred_list.txt points at it (infer_edges.py:113-123)
    np.save(out_base + '_regular.npy', pred)
    # log-depth Spectral colormap
    import matplotlib as mpl
    import matplotlib.cm as cm
    import matplotlib.pyplot as plt
    from PIL import Image
    depth_log = np.log(np.clip(pred, 1e-12, None))
    depth_log = depth_log - depth_log.min()
    depth_log = depth_log / max(depth_log.max(), 1e-12)
    mapper = cm.ScalarMappable(norm=mpl.colors.Normalize(0.0, 1.0),
                               cmap=plt.get_cmap('Spectral'))
    colormapped = (mapper.to_rgba(depth_log)[:, :, :3] * 255).astype(np.uint8)
    Image.fromarray(colormapped).save(out_base + '_regular_color.png')


@torch.no_grad()
def infer_batch(task, rgb, lidar=None, wire_format='u16'):
    """The device work of one batch (``infer_edges.py:218-225``).

    ``rgb`` [B,H,W,3] in [0, 1] on the task's device; ``lidar`` None, a
    dense [B,H,W,1] map in metres, or an (idx [B,cap], val [B,cap] uint16)
    pair from ``wire.encode_lidar_sparse``, scattered to the dense map here.
    Returns the depth of scale 0 [B,H,W] in ``wire_format``.
    """
    if isinstance(lidar, tuple):
        lidar = wire.decode_lidar_sparse(*lidar, rgb.shape[1], rgb.shape[2])
    batch = {'rgb': rgb}
    if lidar is not None:
        batch['input_depth'] = lidar
    depth = inv2depth(task.infer(batch)['inv_depths'][0][..., 0])
    return _ENCODERS[wire_format](depth)


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
    _refuse_unported(args, cfg)

    image_shape = tuple(cfg.datasets.augmentation.image_shape) or None
    task = build_task(cfg, device, ckpt)
    dev = task.device

    with open(cfg.datasets.test.split[0]) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    os.makedirs(cfg.save.folder, exist_ok=True)

    # sparse LiDAR uplink capacity: 12.5 % of pixels (KITTI LiDAR is ~5 %);
    # a batch with a frame over it goes up dense (infer_edges.py:329-337)
    sparse_cap = None
    if args.wire in ('u16', 'u8') and image_shape:
        sparse_cap = (image_shape[0] * image_shape[1]) // 8
    decode = _DECODERS[args.wire]

    pred_files = []
    counter = 0

    def drain(entry):
        nonlocal counter
        (host, done), n_items = entry
        if done is not None:
            done.synchronize()
        depth = decode(host).numpy()
        for b in range(n_items):
            out_base = os.path.join(cfg.save.folder, str(counter).zfill(8))
            save_depth_outputs(depth[b], out_base)
            pred_files.append(out_base + '_regular.npy')
            counter += 1

    in_flight = []
    for i in range(0, len(lines), args.batch):
        chunk = lines[i:i + args.batch]
        inputs = [_read_inputs(ln, cfg, image_shape) for ln in chunk]
        # pad the tail chunk to keep one batch shape
        inputs += [inputs[-1]] * (args.batch - len(inputs))
        rgb = upload(np.stack([r for r, _ in inputs]), dev)
        lidar = None
        if inputs[0][1] is not None:
            sparse = None
            if sparse_cap:
                try:
                    sparse = [wire.encode_lidar_sparse(l, sparse_cap)
                              for _, l in inputs]
                except ValueError:
                    sparse = None   # too dense for the wire: ship dense
            if sparse is not None:
                # indices < H*W <= 2^31: the int32 view keeps their values
                lidar = (upload(np.stack([s[0] for s in sparse]).view(np.int32), dev),
                         upload(np.stack([s[1] for s in sparse]), dev))
            else:
                lidar = upload(np.stack([l for _, l in inputs]), dev)
        depth = infer_batch(task, rgb, lidar, args.wire)
        in_flight.append((start_readback(depth), len(chunk)))
        if len(in_flight) > LAG:
            drain(in_flight.pop(0))
            print(f'Processed {counter}/{len(lines)}')
    for entry in in_flight:
        drain(entry)
    print(f'Processed {counter}/{len(lines)}')

    with open(os.path.join(cfg.save.folder, 'pred_list.txt'), 'w') as f:
        f.writelines(p + '\n' for p in pred_files)
    print('-> Done!')


if __name__ == '__main__':
    main()
