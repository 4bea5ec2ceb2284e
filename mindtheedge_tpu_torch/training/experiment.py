"""Experiment: the training loop, counterpart of
``mindtheedge_tpu/training/experiment.py`` (reference ``ModelWrapper`` and
``CommonTrainer``, ``model_wrapper.py:197-442``, ``common_trainer.py:42-91``).

It owns the task (networks and losses), the datasets and loaders, the train
state and a ``torch.Generator`` on the device seeded from ``arch.seed``
(the lr-flip and dropout draws).  ``fit`` runs the epochs: each batch goes
to the card through pinned memory, one train step, the step's metrics
kept on the card until the epoch's end; then StepLR, validation (depth
metrics with flip post-processing, chamfer edge metrics on the host) and
the top-k checkpoint.

Data parallelism (``experiment.py:112-135, 244-266``) runs one process per
device under ``torchrun``: ``arch.dp_devices`` 0 means the process group's
size, any other value must equal it, and a run asked for more than one
process without a group raises rather than train alone.
``datasets.train.batch_size`` stays the per-process batch, as in the
reference; the training loader gives each rank its chunk of every global
batch (``data/loader.py``), ``fit`` takes ``parallel/mesh.make_dp_train_step``,
``validate`` sums its metrics and its count over the ranks, and rank 0
alone prints, writes the checkpoints and logs the metrics.  Where the JAX
package shrinks the number of devices to fit a small training set, the
port raises: a launched process cannot leave.
"""

import os
import random
import time

import numpy as np
import torch

from mindtheedge_tpu_torch import resolve_device
from mindtheedge_tpu_torch.data.datasets import DATASET_REGISTRY, ConcatDataset
from mindtheedge_tpu_torch.data.loader import DataLoader
from mindtheedge_tpu_torch.data.transforms import get_transforms
from mindtheedge_tpu_torch.losses.loss_base import ProgressiveScaling
from mindtheedge_tpu_torch.models.packnet import to_train_device
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.parallel.distributed import is_main_process, rank, world_size
from mindtheedge_tpu_torch.parallel.mesh import make_dp_train_step
from mindtheedge_tpu_torch.training.checkpoint import (
    ModelCheckpoint, load_checkpoint, restore_depth_net, restore_pose_net,
    restore_train_state)
from mindtheedge_tpu_torch.training.train_step import create_train_state, make_train_step
from mindtheedge_tpu_torch.utils.depth import (
    DEPTH_METRIC_NAMES, compute_depth_metrics, inv2depth, post_process_inv_depth)
from mindtheedge_tpu_torch.utils.image import flip_lr
from mindtheedge_tpu_torch.utils.reduce import reduce_value
from mindtheedge_tpu_torch.utils.wandb_logger import WandbLogger


def set_random_seed(seed):
    """Seed the host draws (shuffles use their own RandomState; colour
    jitter draws from ``random``, LiDAR augmentation from ``np.random``)."""
    np.random.seed(seed)
    random.seed(seed)


def setup_dataset(cfg, mode, **kwargs):
    """The (possibly concatenated) datasets of one mode
    (``experiment.py:40-58``)."""
    datasets = []
    for i in range(len(cfg.path)):
        ds_cls = DATASET_REGISTRY[cfg.dataset[i]]
        datasets.append(ds_cls(
            root_dir=cfg.path[i],
            file_list=cfg.split[i],
            train=(mode == 'train'),
            data_transform=get_transforms(mode=mode, **kwargs),
            depth_type=cfg.depth_type[i] if cfg.depth_type else None,
            input_depth_type=cfg.input_depth_type[i] if cfg.input_depth_type else None,
            back_context=cfg.back_context,
            forward_context=cfg.forward_context))
    if len(datasets) == 1 and (not cfg.get('repeat') or cfg.repeat[0] == 1):
        return datasets[0]
    return ConcatDataset(datasets, repeats=cfg.get('repeat'))


def setup_dataloader(dataset, cfg, mode, seed=42):
    """This rank's loader: its chunk of each global training batch, its
    stride of the evaluation sets."""
    return DataLoader(dataset, batch_size=cfg.batch_size,
                      shuffle=(mode == 'train'),
                      num_workers=min(cfg.num_workers, 4),
                      drop_last=(mode == 'train'), seed=seed,
                      rank=rank(), world_size=world_size())


def batch_to_device(batch, device):
    """numpy batch -> tensors on ``device`` (fields that are not arrays are
    dropped); to the card through pinned memory, without waiting."""
    def upload(a):
        t = torch.from_numpy(a)
        if device.type == 'cuda':
            return t.pin_memory().to(device, non_blocking=True)
        return t

    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = upload(v)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            out[k] = [upload(x) for x in v]
    return out


class Experiment:
    def __init__(self, config, resume_ckpt=None, load_datasets=True, device=None):
        self.world_size = world_size()
        n_dp = config.arch.dp_devices or self.world_size
        if n_dp != self.world_size:
            raise ValueError(
                f'arch.dp_devices {config.arch.dp_devices} asks for {n_dp} '
                f'data-parallel processes, and {self.world_size} run: launch one '
                f'process per device with torchrun --nproc_per_node {n_dp} -m '
                'mindtheedge_tpu_torch.cli.train_edges <config>, or set '
                'arch.dp_devices to 0')
        self.config = config
        self.device = resolve_device(device)
        set_random_seed(config.arch.seed)
        self.task = build_task(config, device=self.device)
        self.task.check_trainable()
        self.generator = torch.Generator(self.device).manual_seed(config.arch.seed)
        params = config.model.params
        self.min_depth, self.max_depth = params.min_depth, params.max_depth
        self.crop, self.scale_output = params.crop, params.scale_output

        self.train_loader = self.val_loader = self.test_loader = None
        if load_datasets:
            aug = config.datasets.augmentation
            kwargs = dict(image_shape=aug.image_shape, jittering=aug.jittering,
                          crop_train_borders=aug.crop_train_borders,
                          crop_eval_borders=aug.crop_eval_borders,
                          lidar_scale=aug.lidar_scale, lidar_add=aug.lidar_add,
                          lidar_drop_rate=aug.lidar_drop_rate)
            def loader(mode):
                cfg = config.datasets[mode]
                if not (cfg.split and cfg.split[0]):
                    return None
                return setup_dataloader(setup_dataset(cfg, mode, **kwargs),
                                        cfg, mode, config.arch.seed)

            self.train_loader = loader('train')
            self.val_loader = loader('validation')
            self.test_loader = loader('test')
        train = self.train_loader
        if self.world_size > 1 and train is not None \
                and len(train.dataset) < train.batch_size * self.world_size:
            raise ValueError(
                f'{len(train.dataset)} training samples cannot fill one global '
                f'batch of {train.batch_size} x {self.world_size} processes')
        self.state = None
        self.resume_ckpt = resume_ckpt

    # -- state --------------------------------------------------------------------
    def initialize_state(self):
        """The depth network in training mode on the device, and the pose
        network where the task has one, restored from the resume checkpoint
        (networks, optimizer, scheduler, epoch, step) or else from
        ``model.depth_net.checkpoint_path`` and
        ``model.pose_net.checkpoint_path`` where those files exist (every
        matching entry, running statistics included).  The pose network's
        file is the reference's (``setup_pose_net``); the JAX package
        reads only the depth network's."""
        net = to_train_device(self.task.depth_net, self.device)
        pose_net = self.task.pose_net
        if not self.resume_ckpt:
            for model, cfg, restore in (
                    (net, self.config.model.depth_net, restore_depth_net),
                    (pose_net, self.config.model.pose_net, restore_pose_net)):
                if model is None or not cfg.checkpoint_path:
                    continue
                if os.path.exists(cfg.checkpoint_path):
                    restore(model, load_checkpoint(cfg.checkpoint_path))
                else:
                    print(f'{cfg.checkpoint_path} not found: training from the '
                          'seeded initialisation')
        self.state = create_train_state(self.config, net, pose_net=pose_net)
        if self.resume_ckpt:
            restore_train_state(self.state, load_checkpoint(self.resume_ckpt))
            print(f'Resumed from {self.resume_ckpt} at epoch {self.state.epoch}, '
                  f'step {self.state.step}')
        return self.state

    # -- validation -----------------------------------------------------------------
    def evaluate_depth(self, batch):
        """Depth of a numpy batch with flip post-processing, and its depth
        metrics where the batch has GT (``experiment.py:196-229``)."""
        tbatch = batch_to_device(batch, self.device)
        inv_depth = self.task.infer(tbatch)['inv_depths'][0][..., :1]
        flipped = dict(tbatch)
        for key in ('rgb', 'input_depth', 'rgb_edge'):
            if key in flipped:
                flipped[key] = flip_lr(flipped[key])
        inv_depth_flipped = self.task.infer(flipped)['inv_depths'][0][..., :1]
        inv_depth_pp = post_process_inv_depth(inv_depth, inv_depth_flipped)
        depth, depth_pp = inv2depth(inv_depth), inv2depth(inv_depth_pp)
        metrics = {}
        if 'depth' in tbatch:
            for name, pred in (('depth', depth), ('depth_pp', depth_pp)):
                for gt_scale in (True, False):
                    m = compute_depth_metrics(
                        tbatch['depth'], pred, self.min_depth, self.max_depth,
                        self.crop, self.scale_output, use_gt_scale=gt_scale)
                    metrics[f'{name}{"_gt" if gt_scale else ""}'] = m.cpu().numpy()
        return {'inv_depth_pp': inv_depth_pp, 'depth': depth,
                'depth_pp': depth_pp, 'metrics': metrics}

    def validate(self):
        """Mean depth metrics and chamfer edge metrics over the validation
        set (``experiment.py:337-381``)."""
        from mindtheedge_tpu_torch.evaluation.edge_metrics import (
            EDGE_METRIC_NAMES, compute_edge_metrics)
        is_dee = 'EdgeEstimation' in self.config.model.name
        gt_crop = self.config.datasets.validation.gt_crop
        gt_crop0 = gt_crop[0] if gt_crop else None
        sums, count = {}, 0
        for batch in self.val_loader:
            result = self.evaluate_depth(batch)
            for key, arr in result['metrics'].items():
                for name, val in zip(DEPTH_METRIC_NAMES, arr):
                    sums[f'{key}/{name}'] = sums.get(f'{key}/{name}', 0.0) + float(val)
            if self.config.edges.depth_edges_metric_log and 'edge' in batch:
                pred = result['inv_depth_pp'] if is_dee else result['depth_pp']
                preds = pred[..., 0].cpu().numpy()
                gts = batch['edge'][..., 0]
                per_sample = [compute_edge_metrics(
                    preds[i], gts[i], is_probability=is_dee, gt_crop=gt_crop0)
                    for i in range(preds.shape[0])]
                for name, val in zip(EDGE_METRIC_NAMES, np.mean(per_sample, axis=0)):
                    sums[f'edges/{name}'] = sums.get(f'edges/{name}', 0.0) + float(val)
            count += 1
        if self.world_size > 1:
            # the sums and counts of the rank-strided shards (experiment.py:369-376)
            keys = sorted(sums)
            *totals, count = reduce_value(
                np.array([sums[k] for k in keys] + [count], np.float64), average=False)
            sums = dict(zip(keys, totals))
        means = {k: v / max(count, 1) for k, v in sums.items()}
        if means and is_main_process():
            print('Validation: ' +
                  ' '.join(f'{k}={v:.4f}' for k, v in sorted(means.items())))
        return means

    # -- training -------------------------------------------------------------------
    def fit(self):
        if self.train_loader is None:
            raise ValueError('No training dataset configured')
        if self.state is None:
            self.initialize_state()
        cfg = self.config
        prog_scaling = ProgressiveScaling(cfg.model.loss.progressive_scaling,
                                          cfg.model.loss.supervised_num_scales)
        base_n = self.task.supervised_num_scales
        ckpt_mgr = ModelCheckpoint(
            filepath=cfg.checkpoint.filepath or 'checkpoints',
            monitor=cfg.checkpoint.monitor, save_top_k=cfg.checkpoint.save_top_k,
            mode=cfg.checkpoint.mode, save_freq=cfg.checkpoint.save_freq,
            s3_path=cfg.checkpoint.s3_path, s3_frequency=cfg.checkpoint.s3_frequency,
            yaml_path=cfg.config or cfg.checkpoint.yaml_path)
        logger = WandbLogger(dir=cfg.checkpoint.filepath or '.',
                             **{k: v for k, v in cfg.wandb.items()
                                if k not in ('dir', 'url')})
        logger.log_config(cfg)
        if self.world_size > 1:
            train_step = make_dp_train_step(self.task)
            if is_main_process():
                print(f'Data-parallel over {self.world_size} processes: global batch '
                      f'{self.train_loader.batch_size * self.world_size} '
                      f'({self.train_loader.batch_size}/process)')
        else:
            train_step = make_train_step(self.task)
        max_epochs = cfg.arch.max_epochs
        try:
            while self.state.epoch < max_epochs:
                epoch = self.state.epoch
                self.train_loader.set_epoch(epoch)
                progress = epoch / max_epochs
                self.task.supervised_num_scales = min(prog_scaling(progress), base_n)
                t0 = time.time()
                running, n_batches = {}, 0
                for batch in self.train_loader:
                    tbatch = batch_to_device(batch, self.device)
                    metrics = train_step(self.state, tbatch, self.generator, progress)
                    n_batches += 1
                    for k, v in metrics.items():
                        running.setdefault(k, []).append(v)
                means = {k: float(torch.stack(v).mean()) for k, v in running.items()}
                self.state.scheduler.step()
                logger.log_metrics({f'train/{k}': v for k, v in means.items()},
                                   global_step=self.state.step)
                ips = (n_batches * self.train_loader.batch_size * self.world_size
                       / max(time.time() - t0, 1e-9))
                if is_main_process():
                    print(f'Epoch {epoch}: ' +
                          ' '.join(f'{k}={v:.4f}' for k, v in sorted(means.items())) +
                          f' ({ips:.2f} img/s)')
                val_metrics = self.validate() if self.val_loader is not None else {}
                if val_metrics:
                    logger.log_metrics({f'val/{k}': v for k, v in val_metrics.items()},
                                       global_step=self.state.step)
                self.state.epoch = epoch + 1
                ckpt_mgr.check_and_save(cfg, self.state, {**means, **val_metrics})
        finally:
            logger.finish()
        return self.state
