"""Default configuration tree: counterpart of
``mindtheedge_tpu/config/defaults.py``, copied whole.

Mirrors the key hierarchy of the reference defaults (reference
``packnet_code/configs/default_config.py:8-289``) so the shipped YAML
configs parse unchanged.  Keys the port does not read yet (training,
multi-device, analysis) are kept so that every config still merges.
"""

from mindtheedge_tpu_torch.config.node import ConfigNode


def get_cfg_defaults():
    cfg = ConfigNode()
    cfg.name = ''
    cfg.debug = False
    cfg.is_multi_gpu = False

    # ARCH -------------------------------------------------------------------
    cfg.arch = ConfigNode()
    cfg.arch.seed = 42
    cfg.arch.min_epochs = 1
    cfg.arch.max_epochs = 51
    cfg.arch.validate_first = False
    cfg.arch.precision = 'float32'   # 'bfloat16' waits for ROADMAP item 9
    # Data-parallel replica count (Horovod per-replica batch semantics:
    # global batch = datasets.train.batch_size x replicas, reference
    # default_config.py:176 batch_size is per-GPU). 0 = all local devices;
    # capped so one global batch fits the dataset.
    cfg.arch.dp_devices = 0

    # CHECKPOINT --------------------------------------------------------------
    cfg.checkpoint = ConfigNode()
    cfg.checkpoint.filepath = ''
    cfg.checkpoint.save_top_k = 5
    cfg.checkpoint.monitor = 'loss'
    cfg.checkpoint.monitor_index = 0
    cfg.checkpoint.mode = 'auto'
    cfg.checkpoint.s3_path = ''
    cfg.checkpoint.s3_frequency = 1
    cfg.checkpoint.save_freq = 5
    cfg.checkpoint.yaml_path = ''

    # SAVE ---------------------------------------------------------------------
    cfg.save = ConfigNode()
    cfg.save.folder = ''
    cfg.save.depth = ConfigNode()
    cfg.save.depth.rgb = True
    cfg.save.depth.viz = True
    cfg.save.depth.npz = True
    cfg.save.depth.png = True
    cfg.save.depth.multiscale = False

    # WANDB ---------------------------------------------------------------------
    cfg.wandb = ConfigNode()
    cfg.wandb.dry_run = True
    cfg.wandb.name = ''
    cfg.wandb.project = ''
    cfg.wandb.entity = ''
    cfg.wandb.tags = []
    cfg.wandb.dir = ''
    cfg.wandb.train_log_step = 50

    # MODEL ---------------------------------------------------------------------
    cfg.model = ConfigNode()
    cfg.model.name = ''
    cfg.model.checkpoint_path = ''

    cfg.model.optimizer = ConfigNode()
    cfg.model.optimizer.name = 'Adam'
    cfg.model.optimizer.depth = ConfigNode()
    cfg.model.optimizer.depth.lr = 0.0002
    cfg.model.optimizer.depth.weight_decay = 0.0
    cfg.model.optimizer.pose = ConfigNode()
    cfg.model.optimizer.pose.lr = 0.0002
    cfg.model.optimizer.pose.weight_decay = 0.0

    cfg.model.scheduler = ConfigNode()
    cfg.model.scheduler.name = 'StepLR'
    cfg.model.scheduler.step_size = 10
    cfg.model.scheduler.gamma = 0.5
    cfg.model.scheduler.T_max = 20

    cfg.model.params = ConfigNode()
    cfg.model.params.crop = ''
    cfg.model.params.min_depth = 0.0
    cfg.model.params.max_depth = 80.0
    cfg.model.params.scale_output = 'resize'

    cfg.model.loss = ConfigNode()
    cfg.model.loss.num_scales = 4
    cfg.model.loss.progressive_scaling = 0.0
    cfg.model.loss.flip_lr_prob = 0.5
    cfg.model.loss.rotation_mode = 'euler'
    cfg.model.loss.upsample_depth_maps = True
    cfg.model.loss.ssim_loss_weight = 0.85
    cfg.model.loss.occ_reg_weight = 0.1
    cfg.model.loss.smooth_loss_weight = 0.001
    cfg.model.loss.C1 = 1e-4
    cfg.model.loss.C2 = 9e-4
    cfg.model.loss.photometric_reduce_op = 'min'
    cfg.model.loss.disp_norm = True
    cfg.model.loss.clip_loss = 0.0
    cfg.model.loss.padding_mode = 'zeros'
    cfg.model.loss.automask_loss = True
    cfg.model.loss.velocity_loss_weight = 0.1
    cfg.model.loss.supervised_method = 'sparse-l1'
    cfg.model.loss.supervised_num_scales = 4
    cfg.model.loss.supervised_loss_weight = 0.9
    cfg.model.loss.depth_edges_loss_weight = 10.0
    cfg.model.loss.edges_depth_edge_loss_all_scales = False
    cfg.model.loss.edges_is_da_on_features = False
    cfg.model.loss.edges_multi_layer_da_on_features = True
    cfg.model.loss.edges_is_da_on_output = False

    # EDGES -------------------------------------------------------------------
    cfg.edges = ConfigNode()
    cfg.edges.train_depth_edges = False
    cfg.edges.depth_edges_loss_weight = 10.0
    cfg.edges.depth_edge_loss_pos_to_neg_weight = 1.0
    cfg.edges.depth_edges_images_log = False
    cfg.edges.depth_edges_metric_log = False
    cfg.edges.fixed_training_seed_sequence = []
    cfg.edges.edge_loss_type = 'cross_entropy'
    cfg.edges.source_target_equal_weight_loss = False
    cfg.edges.idx_example_to_overfit = -1
    cfg.edges.use_external_edges_for_loss = True
    cfg.edges.edge_loss_class_list_to_mask_out = []

    # DEPTH / POSE NETS --------------------------------------------------------
    cfg.model.depth_net = ConfigNode()
    cfg.model.depth_net.name = ''
    cfg.model.depth_net.checkpoint_path = ''
    cfg.model.depth_net.version = ''
    cfg.model.depth_net.dropout = 0.0
    cfg.model.depth_net.freeze_encoder = False
    cfg.model.depth_net.freeze_decoder = False
    cfg.model.depth_net.freeze_san = False
    cfg.model.depth_net.input_channels = 3
    cfg.model.depth_net.remat = False       # training only
    cfg.model.depth_net.channels = ()       # () = architecture default widths
    cfg.model.depth_net.is_depth_aux_net = False
    cfg.model.depth_net.output_channels = 1

    cfg.model.pose_net = ConfigNode()
    cfg.model.pose_net.name = ''
    cfg.model.pose_net.checkpoint_path = ''
    cfg.model.pose_net.version = ''
    cfg.model.pose_net.dropout = 0.0

    # DATASETS -------------------------------------------------------------------
    cfg.datasets = ConfigNode()
    cfg.datasets.augmentation = ConfigNode()
    cfg.datasets.augmentation.image_shape = ()
    cfg.datasets.augmentation.jittering = (0.2, 0.2, 0.2, 0.05)
    cfg.datasets.augmentation.crop_train_borders = ()
    cfg.datasets.augmentation.crop_eval_borders = ()
    cfg.datasets.augmentation.lidar_scale = ()
    cfg.datasets.augmentation.lidar_add = ()
    cfg.datasets.augmentation.lidar_drop_rate = 0.0

    cfg.datasets.train = ConfigNode()
    cfg.datasets.train.batch_size = 8
    cfg.datasets.train.num_workers = 16
    cfg.datasets.train.back_context = 1
    cfg.datasets.train.forward_context = 1
    cfg.datasets.train.dataset = []
    cfg.datasets.train.path = []
    cfg.datasets.train.split = []
    cfg.datasets.train.depth_type = ['']
    cfg.datasets.train.input_depth_type = ['']
    cfg.datasets.train.cameras = [[]]
    cfg.datasets.train.repeat = [1]
    cfg.datasets.train.num_logs = 5

    cfg.datasets.validation = ConfigNode()
    cfg.datasets.validation.batch_size = 1
    cfg.datasets.validation.num_workers = 8
    cfg.datasets.validation.back_context = 0
    cfg.datasets.validation.forward_context = 0
    cfg.datasets.validation.dataset = []
    cfg.datasets.validation.path = []
    cfg.datasets.validation.split = []
    cfg.datasets.validation.depth_type = ['']
    cfg.datasets.validation.input_depth_type = ['']
    cfg.datasets.validation.cameras = [[]]
    cfg.datasets.validation.num_logs = 5
    cfg.datasets.validation.gt_crop = []

    cfg.datasets.test = ConfigNode()
    cfg.datasets.test.batch_size = 1
    cfg.datasets.test.num_workers = 8
    cfg.datasets.test.back_context = 0
    cfg.datasets.test.forward_context = 0
    cfg.datasets.test.dataset = []
    cfg.datasets.test.path = []
    cfg.datasets.test.split = []
    cfg.datasets.test.depth_type = ['']
    cfg.datasets.test.input_depth_type = ['']
    cfg.datasets.test.cameras = [[]]
    cfg.datasets.test.num_logs = 5
    cfg.datasets.test.nms = False
    cfg.datasets.test.hysteresis = False
    cfg.datasets.test.normals = False
    cfg.datasets.test.is_infer_rgb = True
    cfg.datasets.test.is_infer_lidar = True

    # ANALYSIS -------------------------------------------------------------------
    cfg.analysis = ConfigNode()
    cfg.analysis.just_evaluate = False
    cfg.analysis.run_metrics = False
    cfg.analysis.run_light_edge_metrics = False
    cfg.analysis.run_heavy_edge_metrics = False
    cfg.analysis.save_error_plot = False
    cfg.analysis.gt_image_list = ''
    cfg.analysis.edge_image_list = ''
    cfg.analysis.eval_mask_image_list = ''
    cfg.analysis.type = 'dense'
    cfg.analysis.shape = False
    cfg.analysis.intrinsics = False
    cfg.analysis.distortion_params = False
    cfg.analysis.start_frm_idx = 0
    cfg.analysis.end_frm_idx = -1
    cfg.analysis.min_depth = 0.01
    cfg.analysis.max_depth = 80.
    cfg.analysis.prec_recall_eval_range_min = 0.12
    cfg.analysis.prec_recall_eval_range_max = 0.65
    cfg.analysis.gt_crop = [0, 1, 0, 1]
    cfg.analysis.gt_type = 'depth'
    cfg.analysis.rel_err_lo = -1
    cfg.analysis.rel_err_hi = 10.
    cfg.analysis.hist_num_bins = 300
    cfg.analysis.out_file_name = 'analyzer_data.pkl'
    cfg.analysis.median_scaling = 'median_of_fractions'
    cfg.analysis.mask_epipole = False
    cfg.analysis.epipole_mask_radius = -1

    # VISUALIZATION ----------------------------------------------------------------
    cfg.visualization = ConfigNode()
    cfg.visualization.online_vis = False
    cfg.visualization.offline_vis = False

    # INTERNALS -------------------------------------------------------------------
    cfg.config = ''
    cfg.default = ''
    cfg.wandb.url = ''
    cfg.checkpoint.s3_url = ''
    cfg.save.pretrained = ''
    cfg.prepared = False

    return cfg
