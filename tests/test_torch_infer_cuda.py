"""The two inference CLIs on the card, each in a fresh process that sets no
backend flag of its own, against the same ``main`` on the CPU: what a user
running ``python -m mindtheedge_tpu_torch.cli.infer_edges`` or
``cli.infer_edge_estimation`` gets is the precision the parity tests
hold, fp32 with TF32 off, as ``models.packnet.to_device`` sets it.

This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_infer_cuda.py

A 3-frame synthetic split at 64x96 (RGB and uint16 LiDAR PNGs), the SLIM
PackNet-SAN 1A with random weights from the config's seed.  Depth
(``--wire f32``) within rtol 1e-4, as ``chip_smoke.py``'s small slice
holds the network.  The annotation's edge PNGs within one code on >= 99.99
% of their pixels and equal on >= 99.9 %: a PNG holds ``int(edge * 255)``,
so where the two sides' edge values differ by ulps across a code boundary
the codes differ by one (5 of 48,960 pixels in a card run), while a flip of
NMS or hysteresis differs by many.  Normals within one code on >= 99.9 %,
the 4 corners of each map left out (tests/test_torch_cli.py).

In bf16 (``arch.precision: bfloat16``) the card's process is held against
``main`` in bf16 on the CPU within ``BAND`` times the CPU's own
bf16-vs-fp32 gap, as tests/test_torch_cli.py holds the port's bf16 against
the JAX package's: the depth's relative error (median and max), the share
of edge values off by more than 1e-4 and of normals off by more than one
code.  Without a CUDA device the tests skip.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mindtheedge_tpu_torch.cli import infer_edge_estimation, infer_edges
from tests.test_torch_annotate_cuda import normals_within_one_code

ROOT = Path(__file__).resolve().parents[1]
H, W, N = 64, 96, 3
BAND = 2.0


def write_split(root):
    import cv2
    rng = np.random.RandomState(0)
    lines = []
    for i in range(N):
        rp, lp = str(root / f'{i:06d}_rgb.png'), str(root / f'{i:06d}_lidar.png')
        cv2.imwrite(rp, rng.randint(0, 255, (H, W, 3), dtype=np.uint8))
        d = (rng.rand(H, W) * 60.0 * 256.0).astype(np.uint16)
        d[rng.rand(H, W) < 0.95] = 0
        cv2.imwrite(lp, d)
        lines.append(f'{rp} None None {lp} None None None None\n')
    split = root / 'split.txt'
    split.write_text(''.join(lines))
    return str(split)


def write_config(root, name, model, precision='float32', **test):
    import yaml
    cfg = {'arch': {'precision': precision},
           'model': {'name': model, 'depth_net': {'name': 'PackNetSAN01', 'version': '1A'}},
           'datasets': {'augmentation': {'image_shape': [H, W]},
                        'test': {'dataset': ['GTA'], 'path': [''], 'split': [write_split(root)],
                                 'input_depth_type': ['lidar'],
                                 'depth_type': ['groundtruth'], **test}},
           'save': {'folder': str(root / name), 'depth': {'multiscale': True}},
           'checkpoint': {'filepath': ''}}
    path = root / f'{name}.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def card_and_cpu(tmp_path, module, main, name, model, argv=(), precision='float32', **test):
    """``python -m <module>`` on the card in a fresh process, then
    ``main(..., device='cpu')`` here, on the same split and config ->
    (card output folder, CPU output folder)."""
    card = write_config(tmp_path / 'card', name, model, precision, **test)
    out = subprocess.run([sys.executable, '-m', module, '--config', card, *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    cpu = write_config(tmp_path / 'cpu', name, model, precision, **test)
    main(['--config', cpu, *argv], device='cpu')
    return tmp_path / 'card' / name, tmp_path / 'cpu' / name


def cpu_fp32(tmp_path, main, name, model, argv=(), **test):
    """``main`` in fp32 on the CPU on the same split -> its output folder."""
    (tmp_path / 'cpu32').mkdir()
    main(['--config', write_config(tmp_path / 'cpu32', name, model, **test), *argv],
         device='cpu')
    return tmp_path / 'cpu32' / name


@pytest.fixture
def cuda_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    (tmp_path / 'card').mkdir()
    (tmp_path / 'cpu').mkdir()
    return tmp_path


@pytest.mark.cuda
def test_infer_edges_card_process_matches_cpu(cuda_card):
    card, cpu = card_and_cpu(cuda_card, 'mindtheedge_tpu_torch.cli.infer_edges',
                             infer_edges.main, 'depth', 'SemiSupEdgeModel', ['--wire', 'f32'])
    worst = 0.0
    for i in range(N):
        got, want = (np.load(d / f'{i:08d}_regular.npy') for d in (card, cpu))
        assert got.shape == (H, W) and np.isfinite(got).all()
        worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
    assert worst <= 1e-4, f'depth differs by {worst:.3e} of itself'


@pytest.mark.cuda
def test_infer_edge_estimation_card_process_matches_cpu(cuda_card):
    import cv2
    card, cpu = card_and_cpu(
        cuda_card, 'mindtheedge_tpu_torch.cli.infer_edge_estimation', infer_edge_estimation.main,
        'edges', 'EdgeEstimationLIDARModel', is_infer_lidar=True, is_infer_rgb=True,
        nms=True, hysteresis=True, normals=True)
    same = within_one = total = 0
    for i in range(N):
        for tag in ('lidar', 'regular'):
            for s in range(4):
                base = f'{i:08d}_{tag}_{s:03d}.png'
                got, want = (cv2.imread(str(d / base), cv2.IMREAD_UNCHANGED) for d in (card, cpu))
                assert got.shape == want.shape == (H >> s, W >> s)
                codes = np.abs(got.astype(int) - want.astype(int))
                same += int((codes == 0).sum())
                within_one += int((codes <= 1).sum())
                total += got.size
                got, want = (cv2.imread(str(d / 'normals' / base), cv2.IMREAD_UNCHANGED)
                             for d in (card, cpu))
                near = normals_within_one_code(got, want)
                assert near >= 0.999, f'{base} normals within one code on {near:.5f}'
    assert within_one >= 0.9999 * total and same >= 0.999 * total, \
        f'edge PNGs within one code on {within_one}, equal on {same} of {total} pixels'


@pytest.mark.cuda
def test_infer_edges_bf16_card_process_matches_cpu_within_band(cuda_card):
    args = (infer_edges.main, 'depth', 'SemiSupEdgeModel', ['--wire', 'f32'])
    card, cpu = card_and_cpu(cuda_card, 'mindtheedge_tpu_torch.cli.infer_edges', *args,
                             precision='bfloat16')
    cpu32 = cpu_fp32(cuda_card, *args)
    load = lambda d: np.stack([np.load(d / f'{i:08d}_regular.npy') for i in range(N)])
    got, want, want32 = load(card), load(cpu), load(cpu32)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    gap, err = (np.abs(a - b) / b for a, b in ((want, want32), (got, want)))
    assert np.median(err) <= BAND * np.median(gap) and err.max() <= BAND * gap.max(), \
        (np.median(err), err.max(), np.median(gap), gap.max())


@pytest.mark.cuda
def test_infer_edge_estimation_bf16_card_process_matches_cpu_within_band(cuda_card):
    import cv2
    test = dict(is_infer_lidar=True, is_infer_rgb=True, nms=True, hysteresis=True,
                normals=True)
    args = (infer_edge_estimation.main, 'edges', 'EdgeEstimationLIDARModel')
    card, cpu = card_and_cpu(cuda_card, 'mindtheedge_tpu_torch.cli.infer_edge_estimation',
                             *args, precision='bfloat16', **test)
    cpu32 = cpu_fp32(cuda_card, *args, **test)
    off = {'edges': [], 'normals': []}    # (card vs CPU bf16, CPU bf16 vs fp32)
    for i in range(N):
        for tag in ('lidar', 'regular'):
            for s in range(4):
                base = f'{i:08d}_{tag}_{s:03d}'
                got, w16, w32 = (np.load(d / f'{base}.npy') for d in (card, cpu, cpu32))
                assert got.dtype == np.float32
                off['edges'].append((np.mean(np.abs(got - w16) > 1e-4),
                                     np.mean(np.abs(w16 - w32) > 1e-4)))
                got, w16, w32 = (cv2.imread(str(d / 'normals' / f'{base}.png'),
                                            cv2.IMREAD_UNCHANGED) for d in (card, cpu, cpu32))
                off['normals'].append((1 - normals_within_one_code(got, w16),
                                       1 - normals_within_one_code(w16, w32)))
    for kind, pairs in off.items():
        card_off, cpu_off = np.mean(pairs, axis=0)
        assert cpu_off > 0 and card_off <= BAND * cpu_off, (kind, card_off, cpu_off)
