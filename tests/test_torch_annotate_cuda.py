"""The DEE annotation path (``cli/infer_edge_estimation.annotate_batch``) on
the card against the same path on the CPU, and the helpers ``chip_smoke.py``
shares.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_annotate_cuda.py

Without a CUDA device the card tests skip.  The two networks compute in
different conv algorithms (cuDNN vs ATen's CPU convs, TF32 off), so their
probability maps differ by ulps and NMS or hysteresis may flip a near-tie:
edge maps agree within 1e-4 on >= 99.9 % of pixels per scale (the CLI
test's bound, tests/test_torch_cli.py); normals lie within
circular distance 1 on >= 99.9 % (codes 0 and 255 are the same angle),
leaving out each map's 4 corners, where the angle is rounding noise.  On
the same input, hysteresis gives the same bits on the card as on the CPU.
"""

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.cli.infer_edge_estimation import annotate_batch
from mindtheedge_tpu_torch.config import get_cfg_defaults
from mindtheedge_tpu_torch.models.tasks import build_task
from mindtheedge_tpu_torch.ops import edge_ops
from mindtheedge_tpu_torch.ops.cuda import nms_kernel


def task_config(model_name, channels=(), seed=0):
    """A PackNet-SAN 1A task's config, built in code; ``channels`` () are
    the SLIM widths."""
    cfg = get_cfg_defaults()
    cfg.model.name = model_name
    cfg.model.depth_net.name = 'PackNetSAN01'
    cfg.model.depth_net.version = '1A'
    cfg.model.depth_net.channels = tuple(channels)
    cfg.arch.seed = seed
    return cfg


def random_frames(rng, b, h, w, density=0.05):
    """rgb [b,h,w,3] in [0,1] and KITTI-like LiDAR [b,h,w,1] in metres on the
    1/256 m grid of the uint16 PNGs, ``density`` of the pixels set."""
    rgb = rng.rand(b, h, w, 3).astype(np.float32)
    lidar = np.round(rng.rand(b, h, w, 1) * 80.0 * 256.0) / 256.0
    lidar[rng.rand(b, h, w, 1) >= density] = 0.0
    return torch.from_numpy(rgb), torch.from_numpy(lidar.astype(np.float32))


def circular_distance(a, b):
    """Distance between normal codes (tensors or arrays) on the 255-code
    circle: codes 0 and 255 are both the angle +-pi."""
    a, b = (x.double() if torch.is_tensor(x) else torch.tensor(x, dtype=torch.float64)
            for x in (a, b))
    d = (a - b).abs() % 255
    return torch.minimum(d, 255 - d)


def normals_within_one_code(a, b, corners=False):
    """Share of the pixels of [..., h, w] normal maps within circular
    distance 1; without ``corners`` the 4 corners of each map are left out:
    there both reflect-101 Sobel sums vanish, so the angle is rounding
    noise."""
    near = circular_distance(a, b) <= 1
    near = near.reshape(-1, *near.shape[-2:])
    keep = torch.ones(near.shape[-2:], dtype=torch.bool)
    if not corners:
        keep[[0, 0, -1, -1], [0, -1, 0, -1]] = False
    return near[:, keep].double().mean().item()


def annotate_card_vs_cpu(dev, channels=(16,) * 6, shape=(2, 64, 96)):
    """``annotate_batch`` of the same seeded network and inputs on ``dev``
    and on the CPU -> per scale (share of edge pixels within 1e-4, share of
    normals within one code); asserts that hysteresis is bit-equal on the same input and that
    the NMS kernel launched once per scale."""
    cfg = task_config('EdgeEstimationLIDARModel', channels, seed=1)
    cpu_task = build_task(cfg, device='cpu')
    card_task = build_task(cfg, device=dev)
    rgb, lidar = random_frames(np.random.RandomState(1), *shape)
    lidar = lidar / 200.0
    before = nms_kernel.launches
    card = annotate_batch(card_task, rgb.to(dev), lidar.to(dev))
    torch.cuda.synchronize()
    assert nms_kernel.launches == before + 4
    host = annotate_batch(cpu_task, rgb, lidar)
    shares = [(((c['edge'].cpu() - h['edge']).abs() <= 1e-4).double().mean().item(),
               normals_within_one_code(c['normals'].cpu(), h['normals']))
              for c, h in zip(card, host)]
    # hysteresis of the card's own NMS maps, on the card and on the CPU
    out = card_task.run_depth({'rgb': rgb.to(dev), 'input_depth': lidar.to(dev)})
    for inv in out['inv_depths']:
        nms = nms_kernel.non_max_suppression(inv[..., 0] / 2.0)
        assert torch.equal(edge_ops.hysteresis(nms).cpu(),
                           edge_ops.hysteresis(nms.cpu()))
    return shares


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card and nvcc')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
def test_annotate_batch_card_matches_cpu(cuda_card):
    for scale, (edge, normals) in enumerate(annotate_card_vs_cpu(cuda_card)):
        assert edge >= 0.999, f'scale {scale}: edges agree on {edge:.5f}'
        assert normals >= 0.999, f'scale {scale}: normals agree on {normals:.5f}'


@pytest.mark.cuda
def test_sparse_lidar_decode_on_card(cuda_card):
    """The sparse uplink's scatter on the card equals the one on the CPU."""
    from mindtheedge_tpu_torch.ops import wire
    _, lidar = random_frames(np.random.RandomState(2), 2, 64, 96)
    pairs = [wire.encode_lidar_sparse(l.numpy(), 64 * 96 // 8) for l in lidar]
    idx = torch.from_numpy(np.stack([p[0] for p in pairs]).view(np.int32))
    val = torch.from_numpy(np.stack([p[1] for p in pairs]))
    got = wire.decode_lidar_sparse(idx.to(cuda_card), val.to(cuda_card), 64, 96)
    assert torch.equal(got.cpu(), wire.decode_lidar_sparse(idx, val, 64, 96))
    assert torch.equal(got.cpu(), lidar)


@pytest.mark.cuda
def test_infer_batch_has_no_host_sync(cuda_card):
    """One batch of the inference CLI's device work, from pinned upload to
    queued read-back, runs without a host sync (torch's sync debug mode
    raises on one); the read-back then matches the CPU's to one u16 code."""
    from mindtheedge_tpu_torch.cli import infer_edges
    from mindtheedge_tpu_torch.ops import wire
    cfg = task_config('SemiSupEdgeModel', (16,) * 6, seed=2)
    card_task = build_task(cfg, device=cuda_card)
    rgb, lidar = random_frames(np.random.RandomState(3), 2, 64, 96)
    pairs = [wire.encode_lidar_sparse(l.numpy(), 64 * 96 // 8) for l in lidar]
    idx = np.stack([p[0] for p in pairs]).view(np.int32)
    val = np.stack([p[1] for p in pairs])

    def one_batch():
        sparse = (infer_edges.upload(idx, cuda_card), infer_edges.upload(val, cuda_card))
        return infer_edges.start_readback(infer_edges.infer_batch(
            card_task, infer_edges.upload(rgb.numpy(), cuda_card), sparse))

    one_batch()[1].synchronize()            # cuDNN's autotuner syncs once
    torch.cuda.set_sync_debug_mode('error')
    try:
        host, done = one_batch()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    done.synchronize()
    want = infer_edges.infer_batch(build_task(cfg, device='cpu'), rgb, lidar)
    assert host.dtype == torch.uint16 and host.shape == (2, 64, 96)
    assert (host.to(torch.int64) - want.to(torch.int64)).abs().max() <= 1
