"""DEE annotation: depth-edge and normal pseudo-labels on the card.

Counterpart of ``mindtheedge_tpu/cli/infer_edge_estimation.py``, with the
same arguments, outputs and names::

    python -m mindtheedge_tpu_torch.cli.infer_edge_estimation \\
        --config configs/annotate_edges_kitti_training_set.yaml [--batch 4]

For each batch of the split, ``annotate_batch`` runs the DEE network and,
at each of its 4 output scales, halves the inverse depth into an edge
probability, takes its Sobel-angle normal map, thins it with the Sobel-5 +
NMS CUDA kernel (``ops/cuda/nms_kernel``) and runs hysteresis.  Outputs
(reference ``infer_edge_estimation.py:108-117,186-259``):
``{idx:08d}_lidar[_{s:03d}].png/.npy`` edge maps (``_regular`` for the
RGB-only pass), ``normals/{idx:08d}_lidar[_{s:03d}].png`` angle maps and the
8-column ``rgb_lidar_edges_split.txt``.  The card is used unless ``main``
is given ``device='cpu'``.  Under a launcher of several processes each
process annotates the whole split, as the JAX CLI's do.
"""

import argparse
import os

import numpy as np
import torch

from mindtheedge_tpu_torch.config import get_cfg_defaults, parse_test_file, prepare_config
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.ops.cuda.nms_kernel import non_max_suppression
from mindtheedge_tpu_torch.ops.edge_ops import hysteresis_counted, normals_angle_255
from mindtheedge_tpu_torch.parallel.distributed import maybe_initialize_distributed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='DEE pseudo-label annotation')
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--batch', type=int, default=4)
    return parser.parse_args(argv)


def save_split_list(rgb_files, lidar_files, save_folder_edges,
                    save_folder_normals):
    """Write the 8-column training split (``infer_edge_estimation.py:108-117``)."""
    filenames = [str(a).zfill(8) + '_lidar_000.png'
                 for a in range(len(rgb_files))]
    lines = [
        f'{rgb} {lidar} {save_folder_edges}/{fn} {lidar} None None None '
        f'{save_folder_normals}/{fn}\n'
        for rgb, lidar, fn in zip(rgb_files, lidar_files, filenames)]
    with open(os.path.join(save_folder_edges, 'rgb_lidar_edges_split.txt'), 'w') as f:
        f.writelines(lines)


@torch.no_grad()
def annotate_batch(task, rgb, lidar=None, scales=4, nms=True, hyst=True,
                   normals=True):
    """The device work of one batch (``infer_edge_estimation.py:132-166``).

    ``rgb`` [B,H,W,3] in [0, 1] and ``lidar`` [B,H,W,1] already divided by
    200 (or None for the RGB-only pass), on the task's device.  The forward
    is ``task.run_depth``, not ``task.infer``, which would divide the LiDAR
    by 200 again.  Returns one dict per scale: ``edge`` [B,h,w] (the NMS
    and hysteresis output), ``normals`` [B,h,w] float codes or None, and
    ``hysteresis`` (iterations, host checks) or None.
    """
    batch = {'rgb': rgb}
    if lidar is not None:
        batch['input_depth'] = lidar
    out = task.run_depth(batch)
    results = []
    for s in range(scales):
        prob = out['inv_depths'][s][..., 0] / 2.0
        edge, counts = prob, None
        if nms:
            edge = non_max_suppression(edge)
        if hyst:
            edge, iterations, checks = hysteresis_counted(edge)
            counts = (iterations, checks)
        results.append({'edge': edge, 'hysteresis': counts,
                        'normals': normals_angle_255(prob) if normals else None})
    return results


def main(argv=None, device=None):
    args = parse_args(argv)
    maybe_initialize_distributed(device)
    import cv2
    from mindtheedge_tpu_torch.data.augmentations import (
        resize_depth_preserve, resize_image)
    from mindtheedge_tpu_torch.data.readers import (
        GTA_K, load_image, process_lidar, read_lidar, read_png_depth)

    cfg = get_cfg_defaults()
    cfg.merge_from_file(args.config)
    cfg = prepare_config(cfg)
    ckpt = None
    if cfg.checkpoint.filepath and os.path.isfile(cfg.checkpoint.filepath):
        cfg, ckpt = parse_test_file(cfg.checkpoint.filepath, args.config)
    else:
        print(f'WARNING: checkpoint {cfg.checkpoint.filepath!r} not found — '
              'random init (smoke mode)')

    image_shape = tuple(cfg.datasets.augmentation.image_shape)
    task = build_task(cfg, device, ckpt)
    test_cfg = cfg.datasets.test

    with open(test_cfg.split[0]) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    files = [ln.split(' ')[0] for ln in lines]
    lidar_files = [ln.split(' ')[3] for ln in lines]

    out_dir = cfg.save.folder
    os.makedirs(out_dir, exist_ok=True)
    normals_dir = os.path.join(out_dir, 'normals')
    if test_cfg.normals:
        os.makedirs(normals_dir, exist_ok=True)

    scales = 4 if cfg.save.depth.multiscale else 1
    options = dict(scales=scales, nms=bool(test_cfg.nms),
                   hyst=bool(test_cfg.hysteresis),
                   normals=bool(test_cfg.normals))

    def read_pair(rgb_path, lidar_path):
        image = load_image(rgb_path)
        if image.size != (image_shape[1], image_shape[0]):
            image = resize_image(image, image_shape)
        rgb = np.asarray(image, dtype=np.float32) / 255.0
        lidar = None
        if test_cfg.is_infer_lidar and lidar_path not in ('', 'None'):
            ext = lidar_path.rsplit('.', 1)[-1]
            if ext == 'png':
                lidar = read_png_depth(lidar_path)
                lidar[lidar < 0] = 0.0
            elif ext == 'bin':
                lidar = process_lidar(read_lidar(lidar_path), GTA_K)
            elif ext == 'npy':
                lidar = np.load(lidar_path)
            lidar = lidar / 200.0   # infer_edge_estimation.py:223
            if lidar.shape[:2] != tuple(image_shape):
                lidar = resize_depth_preserve(lidar, image_shape)
            lidar = lidar.reshape(image_shape[0], image_shape[1], 1).astype(np.float32)
        return rgb, lidar

    def upload(arrays):
        return torch.from_numpy(np.stack(arrays)).to(task.device)

    counter = 0
    for i in range(0, len(files), args.batch):
        chunk = list(zip(files[i:i + args.batch], lidar_files[i:i + args.batch]))
        pairs = [read_pair(rgb_path, lidar_path) for rgb_path, lidar_path in chunk]
        rgb = upload([r for r, _ in pairs])
        lidar = None if pairs[0][1] is None else upload([l for _, l in pairs])

        def write(results, tag):
            results = [(r['edge'].cpu().numpy(), None if r['normals'] is None
                        else r['normals'].cpu().numpy()) for r in results]
            for b in range(len(chunk)):
                base = os.path.join(out_dir, str(counter + b).zfill(8))
                for s in range(scales):
                    end = f'_{tag}' if scales == 1 else f'_{tag}_{s:03d}'
                    edge, normals = results[s]
                    cv2.imwrite(base + end + '.png',
                                np.clip(edge[b] * 255, 0, 255).astype(np.uint8))
                    if cfg.save.depth.npz:
                        np.save(base + end + '.npy', edge[b])
                    if normals is not None:
                        npath = os.path.join(
                            normals_dir, str(counter + b).zfill(8) + end + '.png')
                        cv2.imwrite(npath, normals[b].astype(np.uint8))

        if test_cfg.is_infer_rgb:
            # RGB-only edge maps, '_regular' suffix (ref :186-190)
            write(annotate_batch(task, rgb, None, **options), 'regular')
        if test_cfg.is_infer_lidar and lidar is not None:
            write(annotate_batch(task, rgb, lidar, **options), 'lidar')
        counter += len(chunk)
        print(f'Processed image {counter}')

    save_split_list(files, lidar_files, out_dir, normals_dir)
    print('-> Done!')


if __name__ == '__main__':
    main()
