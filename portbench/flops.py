"""The yardstick's arithmetic: model FLOPs, the NMS kernel's bound, peaks.

Every roofline and ``mfu`` metric reads these functions.  They count the
work the configuration needs from its shapes, whatever implements it:

* each dense convolution at its shapes, 2 * C_in * C_out * K * (output
  sites) FLOP (a multiply and an add per weight and site);
* the SAN ladder's sparse convolutions at the site pairs that a sparse
  convolution computes (MinkowskiEngine's, as the published code runs
  them): for each output site active at its level, the kernel offsets
  whose input site is active too, from the LiDAR mask.  The masked-dense
  grid that a dense implementation computes is not counted;
* training: the forward of the RGB pass and of the RGBD pass (which the
  task runs for its statistics), and the backward that the loss reaches,
  the RGB pass's: a data and a weight gradient per conv, but no data
  gradient into the input image.

Peaks are the H100 SXM data sheet's dense rates at its 700 W limit.
"""

import torch
import torch.nn.functional as F

PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}   # no TF32: the fp32 cells turn it off
HBM_BYTES_PER_S = 3.35e12
NMS_FLOPS_PER_PX = 40   # the separable Sobel-5 pair (32) and the direction tests

NUM_BLOCKS = (2, 2, 3, 3)
PACK_KERNEL = (5, 3, 3, 3, 3)
SAN_KERNEL = (5, 5, 3, 3, 3)
D3 = 4


def conv_flops(c_in, c_out, kernel_elems, out_sites):
    """FLOP of a dense convolution: ``kernel_elems`` weights per input and
    output channel, ``out_sites`` output sites (one image)."""
    return 2 * c_in * c_out * kernel_elems * out_sites


def sparse_conv_flops(c_in, c_out, pairs):
    """FLOP of a sparse convolution over ``pairs`` (output site, active
    input site) pairs."""
    return 2 * c_in * c_out * pairs


def packnet_convs(channels, h, w):
    """[(name, c_in, c_out, kernel elements, output sites, takes the image)]
    of every dense conv of PackNet-SAN 1A's encoder and decoder (one image)."""
    ni, n1, n2, n3, n4, n5 = channels
    widths = (n1, n2, n3, n4, n5)
    convs = [('encoder.pre_calc', 3, ni, 25, h * w, True),
             ('encoder.conv1', ni, n1, 49, h * w, False)]
    sites = h * w
    for i, c in enumerate(widths):
        if i:
            for j in range(NUM_BLOCKS[i - 1]):
                cin = widths[i - 1] if j == 0 else c
                p = f'encoder.conv{i + 1}.{j}'
                convs += [(f'{p}.conv1', cin, c, 9, sites, False),
                          (f'{p}.conv2', c, c, 9, sites, False),
                          (f'{p}.conv3', cin, c, 1, sites, False)]
        sites //= 4
        convs += [(f'encoder.pack{i + 1}.conv3d', 1, D3, 27, c * 4 * sites, False),
                  (f'encoder.pack{i + 1}.conv', c * 4 * D3, c, PACK_KERNEL[i] ** 2, sites, False)]
    unpack = [(5, n5, n5), (4, n5, n4), (3, n4, n3), (2, n3, n2), (1, n2, n1)]
    iconv = [n5 + n4, n4 + n3, n3 + n2 + 1, n2 + n1 + 1, n1 + ni + 1]
    for (lvl, cin, cout), icin in zip(unpack, iconv):
        # the unpack conv runs at the coarse level, its 3-D conv and the
        # iconv at the fine one (4x the sites)
        convs += [(f'decoder.unpack{lvl}.conv', cin, cout, 9, sites, False),
                  (f'decoder.unpack{lvl}.conv3d', 1, D3, 27, cout * sites, False)]
        sites *= 4
        convs.append((f'decoder.iconv{lvl}', icin, cout, 9, sites, False))
        if lvl <= 4:
            convs.append((f'decoder.disp{lvl}_layer', cout, 1, 9, sites, False))
    return convs


def san_convs(channels):
    """[(level, c_in, c_out, kernel size)] of the SAN ladder's sparse convs."""
    ni, n1, n2, n3, n4, n5 = channels
    widths = (n1, n2, n3, n4, n5)
    ins = (1,) + widths[:-1]
    out = []
    for lvl, (cin, c, k) in enumerate(zip(ins, widths, SAN_KERNEL)):
        out += [(lvl, cin, c, k), (lvl, cin, 2 * c, k), (lvl, 2 * c, c, k),
                (lvl, cin, 2 * c, k), (lvl, 2 * c, 2 * c, k), (lvl, 2 * c, c, k)]
    return out


def san_masks(lidar):
    """The active sites of each SAN level: ``lidar`` [B,1,H,W] (0 = no
    point) -> 5 boolean masks at strides 2..32; a site is active where
    any input site of its 2x2 cell is."""
    mask = (lidar > 0).float()
    masks = []
    for _ in SAN_KERNEL:
        mask = (F.max_pool2d(mask, 2, 2, ceil_mode=True) > 0).float()
        masks.append(mask)
    return masks


def site_pairs(mask, k):
    """(output site, active input site) pairs of a k x k conv at stride 1
    over the active sites of ``mask`` [B,1,h,w], summed over the batch."""
    ones = torch.ones(1, 1, k, k, dtype=torch.float64, device=mask.device)
    m = mask.double()
    return float((m * F.conv2d(m, ones, padding=k // 2)).sum())


def packnet_forward_flops(channels, h, w, lidar=None, sparse=True):
    """Model FLOP of one eval forward of a batch: ``lidar`` [B,1,H,W] or
    [B,H,W,1] (0 = no point) adds the SAN ladder, at its active site pairs
    (``sparse``) or densely; None is the RGB-only forward."""
    dense = sum(conv_flops(ci, co, k, s) for _, ci, co, k, s, _ in packnet_convs(channels, h, w))
    if lidar is None:
        return dense, 0.0
    if lidar.shape[-1] == 1 and lidar.shape[1] != 1:
        lidar = lidar.permute(0, 3, 1, 2)
    b = lidar.shape[0]
    masks = san_masks(lidar)
    san = 0.0
    for lvl, ci, co, k in san_convs(channels):
        if sparse:
            san += sparse_conv_flops(ci, co, site_pairs(masks[lvl], k))
        else:
            mh, mw = masks[lvl].shape[-2:]
            san += b * conv_flops(ci, co, k * k, mh * mw)
    return b * dense, san


def packnet_train_flops(channels, h, w, lidar, sparse=True):
    """Model FLOP of one training step of a batch of the paper's task:
    the RGB pass forward and backward, the RGBD pass forward (statistics
    only)."""
    b = lidar.shape[0]
    convs = packnet_convs(channels, h, w)
    fwd = sum(conv_flops(ci, co, k, s) for _, ci, co, k, s, _ in convs)
    bwd = sum(conv_flops(ci, co, k, s) * (1 if image else 2) for _, ci, co, k, s, image in convs)
    rgbd_dense, san = packnet_forward_flops(channels, h, w, lidar, sparse)
    return b * (fwd + bwd) + rgbd_dense + san


def nms_bound_s(numel):
    """(least seconds the card could take for the Sobel-5 + NMS of ``numel``
    float32 pixels, 'bytes' or 'operations'): one read and one write a
    pixel at the HBM rate, or the operations at the fp32 peak, whichever
    is longer."""
    bytes_s = 2 * 4 * numel / HBM_BYTES_PER_S
    flops_s = NMS_FLOPS_PER_PX * numel / PEAK_FLOPS['float32']
    return max(bytes_s, flops_s), 'bytes' if bytes_s >= flops_s else 'operations'
