"""Entry ``serve``: ``serve.serve(model, rgb_u8, lidar, wire)``, one request
per timed unit.

Set-up builds PackNet-SAN on the device with the benchmark's weights
through the program's ``models.packnet.to_device`` (cast once to the
mix's ``precision``, as ``serve.build`` does), makes the request pool and
answers ``warmup`` requests.  A unit sends the next request of the pool
and reads the u16 depth and the bit-packed edges back to the host.

The check runs the reference on a sample of the answered requests: the
served u16 depth against the exact wire value of the reference's depth
(the largest error beyond the half unit of rounding, relative to the
value), the served edge bits against the reference's NMS of
``clip(inv / 2, 0, 1)`` over 0.5.  Where the mix serves below fp32, the
share of edge bits unlike the fp32 reference's swings with the seed's
weights (how much of the map lies near a decision), so it is also read
over the share that the plain reference computed in the mix's precision
gets wrong on the same requests.
"""

import time

import numpy as np
import torch

from portbench import flops
from portbench.common import DTYPES, release, synchronize
from portbench.reference import edges as ref_edges
from portbench.reference import packnet as ref_net
from portbench.reference.precision import control, tf32
from portbench.traffic import serve_pool, stream_seed


def _edge_bits(inv):
    """The edge bits of an inverse depth map: its NMS of ``clip(inv / 2)``
    over 0.5, on the host."""
    return (ref_edges.nms(torch.clamp(inv / 2.0, 0.0, 1.0)) > 0.5).cpu().numpy()


def _pack_bits(bits):
    return torch.from_numpy(np.packbits(bits.astype(np.uint8), axis=-1))


class Cell:
    kind = 'infer'

    def __init__(self, config, traffic, seed, device, program='port'):
        self.device = torch.device(device)
        self.precision = traffic['precision']
        self.channels = tuple(config['channels'])
        self.h, self.w = config['image_shape']
        self.images_per_unit = traffic['batch']
        self.sample_size = traffic['check']['requests']
        self.limits = traffic['check']['limits']
        self.weights = ref_net.make_weights(self.channels, stream_seed(seed, 'weights'), self.device)
        self.pool = serve_pool(traffic, self.h, self.w, seed, self.device)
        self.model = None
        if program == 'port':
            self._build_port(traffic['wire'])
        else:
            quant, tf32_on = control(self.precision)
            self._answer = lambda rgb, lidar: self._reference_answer(rgb, lidar, quant, tf32_on)
        t0 = time.perf_counter()
        for i in range(traffic['warmup']):
            self.unit(i)
        synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0

    def _build_port(self, wire):
        from mindtheedge_tpu_torch import serve
        from mindtheedge_tpu_torch.models.packnet import PackNetSAN, to_device
        with torch.device('meta'):
            net = PackNetSAN(self.channels)
        net = net.to_empty(device=self.device)
        net.load_state_dict(self.weights)
        self.model = to_device(net, self.device, DTYPES[self.precision])
        self._answer = lambda rgb, lidar: serve.serve(self.model, rgb, lidar, wire=wire)

    def _reference_answer(self, rgb_u8, lidar, quant, tf32_on):
        """The reference in the program's place (the control): its depth
        and edges encoded for the wire."""
        with tf32(tf32_on), torch.no_grad():
            rgb = rgb_u8.to(self.device).float() / 255.0
            kwargs = {} if quant is None else {'quant': quant}
            inv = ref_net.infer(self.weights, rgb, lidar.to(self.device), **kwargs)[0]
        depth = torch.round(ref_edges.depth_units(inv)).to(torch.int32).to(torch.uint16)
        return depth, _pack_bits(_edge_bits(inv))

    def unit(self, i):
        k = i % len(self.pool)
        depth, edges = self._answer(*self.pool[k])
        return k, (depth.cpu(), edges.cpu())

    def attach(self, spans):
        if self.model is not None:
            spans.hook_module(self.model, 'network_fwd')

    def flops_per_unit(self):
        total = 0.0
        for _, lidar in self.pool:
            dense, san = flops.packnet_forward_flops(self.channels, self.h, self.w,
                                                     lidar.to(self.device))
            total += dense + san
        return total / len(self.pool)

    def nms_per_unit(self):
        """(launches, bound seconds) of the NMS kernel in one request."""
        return 1, flops.nms_bound_s(self.images_per_unit * self.h * self.w)[0]

    def release(self):
        self.model = self._answer = None
        release(self.device)

    @torch.no_grad()
    def check(self, samples):
        self.release()
        excess, mismatched, plain_mismatched, pixels = -1.0, 0, 0, 0
        below_fp32 = self.precision != 'float32'
        with tf32(False):
            for k, (depth, packed) in samples:
                rgb_u8, lidar = self.pool[k]
                rgb = rgb_u8.to(self.device).float() / 255.0
                lidar = lidar.to(self.device)
                inv = ref_net.infer(self.weights, rgb, lidar)[0]
                want = ref_edges.depth_units(inv).double().cpu()
                err = (depth.to(torch.int32).double() - want).abs() - 0.5
                excess = max(excess, float((err / want.clamp(min=1.0)).max()))
                bits = _edge_bits(inv)
                served = np.unpackbits(packed.numpy(), axis=-1).astype(bool)
                mismatched += int((served != bits).sum())
                pixels += bits.size
                if below_fp32:
                    plain = ref_net.infer(self.weights, rgb, lidar, DTYPES[self.precision])[0]
                    plain_mismatched += int((_edge_bits(plain) != bits).sum())
        numbers = {'depth_rel_excess': excess, 'edge_mismatch_share': mismatched / max(pixels, 1)}
        if below_fp32:
            numbers['edge_mismatch_over_plain'] = mismatched / max(plain_mismatched, 1)
        return numbers
