"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is compiled
for ``sm_90a`` into ``build/kernels/<name>_<hash>.so`` at the repository
root, where the hash covers the source and the flags, so an edited source
builds anew and an unchanged one is reused.  Only sources in the repository
are compiled.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, 'bin', 'nvcc').exists():
        return str(Path(CUDA_HOME, 'bin', 'nvcc'))
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (set CUDA_HOME or put nvcc on PATH)')
    return nvcc


def library_path(name):
    """Where ``csrc/<name>.cu`` is built, keyed by the hash of source and flags."""
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'{name}_{digest}.so'


def build(*names):
    """Compile every named kernel that is not built yet, all nvcc processes
    at once.  Returns {name: ptxas report} for the kernels it compiled."""
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f'{name}:\n{reports[name]}')
        else:
            os.replace(tmp, todo[name])   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return reports


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
