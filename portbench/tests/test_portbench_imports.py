"""Nothing that portbench runs imports JAX, the JAX package or the repo's
tests, and the reference imports nothing of the program: each imported
module's top-level name (the part before the first dot), compared whole."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.common import HERE, ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'mindtheedge_tpu', 'tests'}
REFERENCE_FORBIDDEN = FORBIDDEN | {'mindtheedge_tpu_torch'}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


SOURCES = sorted(p for p in HERE.rglob('*.py') if 'tests' not in p.relative_to(HERE).parts)


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_sources_import_no_jax(path):
    rel = path.relative_to(HERE)
    forbidden = REFERENCE_FORBIDDEN if rel.parts[0] == 'reference' else FORBIDDEN
    assert not top_level_imports(path) & forbidden


def test_the_program_is_not_the_jax_package():
    # 'mindtheedge_tpu_torch' starts with the JAX package's name and passes
    assert 'mindtheedge_tpu_torch'.split('.')[0] not in FORBIDDEN
    assert 'mindtheedge_tpu'.split('.')[0] in FORBIDDEN


def test_a_dry_run_loads_no_jax():
    """A whole run, in a process of its own, then its ``sys.modules``."""
    out = subprocess.run([sys.executable, '-m', 'portbench.tests.tiny', 'san.serve.b4', '7', '0'],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert 'mindtheedge_tpu_torch' in loaded
    assert not loaded & FORBIDDEN
