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


def test_every_submodule_imports_with_jax_blocked():
    names = [m.name for m in pkgutil.walk_packages(
        [str(PACKAGE)], prefix='mindtheedge_tpu_torch.')]
    assert 'mindtheedge_tpu_torch.serve' in names
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['mindtheedge_tpu'] = None\n"
            "import mindtheedge_tpu_torch\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


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
