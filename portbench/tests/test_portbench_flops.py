"""portbench/flops.py against hand counts and against PyTorch's own count."""

import pytest
import torch

from portbench import flops


def test_one_conv():
    # 3x3 conv, 16 -> 32 channels, 10 x 20 output: 2 * 16 * 32 * 9 * 200
    assert flops.conv_flops(16, 32, 9, 200) == 1_843_200


def test_one_3d_conv():
    # the pack layer's 3-D conv: 1 -> 4 features, 3x3x3, over D=8 channels at 4 x 6
    assert flops.conv_flops(1, 4, 27, 8 * 4 * 6) == 2 * 4 * 27 * 192


def test_one_sparse_conv():
    # three active sites in a row of a 1 x 5 map, a 3x3 kernel: the middle
    # site sees both neighbours, the ends one each -> 3 + 2 * 2 = 7 pairs
    mask = torch.zeros(1, 1, 1, 5)
    mask[..., 1:4] = 1
    assert flops.site_pairs(mask, 3) == 7
    assert flops.sparse_conv_flops(2, 3, 7) == 2 * 2 * 3 * 7


def test_san_masks_pool_2x2_cells():
    lidar = torch.zeros(1, 1, 8, 8)
    lidar[0, 0, 0, 0] = 5.0
    masks = flops.san_masks(lidar)
    assert [int(m.sum()) for m in masks] == [1, 1, 1, 1, 1]
    assert [tuple(m.shape[-2:]) for m in masks] == [(4, 4), (2, 2), (1, 1), (1, 1), (1, 1)]


@pytest.mark.parametrize('with_lidar', [False, True])
def test_dense_count_is_pytorchs(with_lidar):
    """The dense count equals FlopCounterMode's over the port's network."""
    from torch.utils.flop_counter import FlopCounterMode
    from mindtheedge_tpu_torch.models.packnet import SLIM_CHANNELS, PackNetSAN
    torch.manual_seed(0)
    net = PackNetSAN(SLIM_CHANNELS).eval()
    rgb = torch.rand(1, 64, 96, 3)
    lidar = torch.where(torch.rand(1, 64, 96, 1) < 0.05, 10.0, 0.0) if with_lidar else None
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(rgb, lidar)
    dense, san = flops.packnet_forward_flops(SLIM_CHANNELS, 64, 96, lidar, sparse=False)
    assert dense + san == counter.get_total_flops()


def test_sparse_count_below_dense():
    from mindtheedge_tpu_torch.models.packnet import SLIM_CHANNELS
    lidar = torch.where(torch.rand(2, 1, 64, 96) < 0.05, 10.0, 0.0)
    _, sparse = flops.packnet_forward_flops(SLIM_CHANNELS, 64, 96, lidar)
    _, dense = flops.packnet_forward_flops(SLIM_CHANNELS, 64, 96, lidar, sparse=False)
    assert 0 < sparse < dense


def test_nms_bound_is_bytes_at_full_width():
    seconds, bound = flops.nms_bound_s(4 * 384 * 1280)
    assert bound == 'bytes' and seconds == pytest.approx(8 * 4 * 384 * 1280 / 3.35e12)
