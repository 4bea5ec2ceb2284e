"""The port stands alone: it imports neither JAX nor the JAX package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import mindtheedge_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(mindtheedge_tpu_torch.__file__).resolve().parent


def _forbidden(module):
    return (module == 'jax' or module.startswith('jax.')
            or module == 'mindtheedge_tpu'
            or module.startswith('mindtheedge_tpu.'))


def _import_all_with_blocked(blocked):
    """Import every submodule of the port in a fresh interpreter in which
    the ``blocked`` modules cannot be imported."""
    names = [m.name for m in pkgutil.walk_packages(
        [str(PACKAGE)], prefix='mindtheedge_tpu_torch.')]
    for name in ('serve', 'cli.infer_edges', 'cli.infer_edge_estimation',
                 'config', 'data.readers', 'models.tasks', 'training.checkpoint',
                 'cli.train_edges', 'training.experiment', 'training.optimizer',
                 'training.train_step', 'training.state', 'training.trainer',
                 'losses.grad_loss', 'losses.supervised', 'losses.loss_base',
                 'models.model_utils', 'utils.image', 'utils.profiling',
                 'utils.wandb_logger', 'data.datasets', 'data.loader',
                 'data.transforms', 'evaluation.edge_metrics', 'evaluation.chamfer',
                 'geometry.pose', 'geometry.camera', 'geometry.camera_generic',
                 'losses.photometric',
                 'models.posenet', 'models.resnet', 'data.kitti_dataset',
                 'data.kitti_utils', 'evaluation.bsds_matcher', 'evaluation.edge_auc',
                 'evaluation.d3r', 'evaluation.depth_analyzer', 'cli.eval_depth',
                 'cli.eval_depth_edges', 'utils.colormap', 'utils.save', 'utils.reduce',
                 'utils.misc', 'utils.logging', 'parallel.distributed',
                 'parallel.mesh', 'parallel.spatial', 'ops.canny', 'ops.lidar_sim'):
        assert f'mindtheedge_tpu_torch.{name}' in names
    code = ("import sys, importlib\n"
            f"for b in {list(blocked)!r}:\n"
            "    sys.modules[b] = None\n"
            "import mindtheedge_tpu_torch\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


def test_every_submodule_imports_with_jax_blocked():
    _import_all_with_blocked(('jax', 'mindtheedge_tpu'))


def test_every_submodule_imports_without_host_io_packages():
    """The card's machine may lack matplotlib, cv2, yaml, PIL or pandas: the
    port imports them only inside the host I/O functions that use them."""
    _import_all_with_blocked(('jax', 'mindtheedge_tpu', 'matplotlib', 'cv2',
                              'yaml', 'PIL', 'pandas'))


def test_bsds_matcher_builds_nothing_under_native():
    """The port's matcher reads ``native/bsds/matcher.cpp`` and builds into
    ``build/native/``: importing and calling it in a fresh interpreter
    leaves ``native/`` as it was, and the depth metrics run with pandas and
    matplotlib blocked."""
    native = ROOT / 'native'
    before = {p: p.stat().st_mtime_ns for p in native.rglob('*')}
    code = ("import sys\n"
            "for b in ('jax', 'mindtheedge_tpu', 'pandas', 'matplotlib'):\n"
            "    sys.modules[b] = None\n"
            "import numpy as np\n"
            "from mindtheedge_tpu_torch.evaluation import bsds_matcher as bm\n"
            "from mindtheedge_tpu_torch.evaluation.depth_analyzer import column_means\n"
            "m = np.eye(8, dtype=np.uint8)\n"
            "assert bm.correspond_pixels(m, m, 0.01)[2] == 8.0\n"
            "assert bm.binary_thin(m).sum() > 0\n"
            "assert column_means([[0, 0.1, 0.2, 0.3, np.float32(1), np.float32(1), 1.0]])\n"
            "print(bm.backend(), bm.library_path())\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    backend, path = out.stdout.split()
    assert backend == 'native' and Path(path).parent == ROOT / 'build' / 'native'
    assert {p: p.stat().st_mtime_ns for p in native.rglob('*')} == before


def test_sources_name_no_jax_import():
    files = sorted(PACKAGE.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            else:
                continue
            bad += [f'{f.relative_to(ROOT)}:{node.lineno} {m}'
                    for m in mods if _forbidden(m)]
    assert not bad, bad
