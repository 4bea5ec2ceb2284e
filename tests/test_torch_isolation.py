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
                 'config', 'data.readers', 'models.tasks', 'training.checkpoint'):
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
    """The card's machine may lack matplotlib, cv2, yaml or PIL: the port
    imports them only inside the host I/O functions that use them."""
    _import_all_with_blocked(('jax', 'mindtheedge_tpu', 'matplotlib', 'cv2',
                              'yaml', 'PIL'))


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
