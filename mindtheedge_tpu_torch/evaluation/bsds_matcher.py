"""BSDS boundary matcher, bound with ctypes: counterpart of
``mindtheedge_tpu/evaluation/bsds_matcher.py:1-131``.

The C++ source is the repository's ``native/bsds/matcher.cpp``
(Hopcroft-Karp on the distance-bounded graph, Zhang-Suen thinning), read
and never written here.  At first use it is compiled with ``g++`` into
``build/native/libbsds_matcher_<hash>.so`` at the repository root, where
the hash covers the source and the flags, as ``ops/cuda/build.py`` keys the
NMS kernel; concurrent builds each write a temporary file and rename it
into place.  Without a compiler ``correspond_pixels`` uses scipy's
Hopcroft-Karp, which gives the same match counts, and ``binary_thin``
raises, as the JAX binding does.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / 'native' / 'bsds' / 'matcher.cpp'
BUILD_DIR = ROOT / 'build' / 'native'
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lib = None
_lib_failed = False


def library_path():
    """Where the matcher is built, keyed by the hash of source and flags."""
    digest = hashlib.sha256(SRC.read_bytes() + ' '.join(GXX_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f'libbsds_matcher_{digest}.so'


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    subprocess.check_call(['g++', *GXX_FLAGS, str(SRC), '-o', str(tmp)])
    os.replace(tmp, out)        # atomic: concurrent builds agree


def _get_lib():
    """The loaded library, built at first use; None where it cannot be built
    or loaded (then ``correspond_pixels`` takes the scipy path)."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.correspond_pixels.restype = ctypes.c_int
    lib.correspond_pixels.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_double, u8p, u8p]
    lib.binary_thin.restype = None
    lib.binary_thin.argtypes = [u8p, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def backend():
    """'native' where the g++-built library serves the matching, else 'scipy'."""
    return 'native' if _get_lib() is not None else 'scipy'


def _as_u8(m):
    return np.ascontiguousarray((np.asarray(m) != 0).astype(np.uint8))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def correspond_pixels(pred, gt, max_dist=0.0075):
    """Match pred/gt boundary pixels within ``max_dist`` * the diagonal
    (``bsds_matcher.py:57-83``) -> (match1, match2, matched count, 0.0):
    {0,1} uint8 maps of the pred and gt pixels that found a partner."""
    pred = _as_u8(pred)
    gt = _as_u8(gt)
    h, w = pred.shape
    if gt.shape != (h, w):
        raise ValueError(f'shape mismatch {pred.shape} vs {gt.shape}')
    lib = _get_lib()
    if lib is None:
        return _correspond_pixels_scipy(pred, gt, max_dist)
    match1 = np.zeros((h, w), dtype=np.uint8)
    match2 = np.zeros((h, w), dtype=np.uint8)
    n = lib.correspond_pixels(_ptr(pred), _ptr(gt), h, w, float(max_dist),
                              _ptr(match1), _ptr(match2))
    return match1, match2, float(n), 0.0


def _correspond_pixels_scipy(pred, gt, max_dist):
    """scipy's Hopcroft-Karp on the same graph (``bsds_matcher.py:86-120``):
    the same maximum-cardinality counts as the native matcher."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    h, w = pred.shape
    r = max_dist * np.hypot(h, w)
    ri = int(np.ceil(r))
    py, px = np.nonzero(pred)
    gy, gx = np.nonzero(gt)
    match1 = np.zeros((h, w), dtype=np.uint8)
    match2 = np.zeros((h, w), dtype=np.uint8)
    if len(py) == 0 or len(gy) == 0:
        return match1, match2, 0.0, 0.0

    gt_id = -np.ones((h, w), dtype=np.int64)
    gt_id[gy, gx] = np.arange(len(gy))
    rows, cols = [], []
    offsets = [(dy, dx) for dy in range(-ri, ri + 1)
               for dx in range(-ri, ri + 1) if dy * dy + dx * dx <= r * r]
    for k in range(len(py)):
        y, x = py[k], px[k]
        for dy, dx in offsets:
            yy, xx = y + dy, x + dx
            if 0 <= yy < h and 0 <= xx < w and gt_id[yy, xx] >= 0:
                rows.append(k)
                cols.append(gt_id[yy, xx])
    if not rows:
        return match1, match2, 0.0, 0.0
    graph = csr_matrix((np.ones(len(rows), dtype=np.int8), (rows, cols)),
                       shape=(len(py), len(gy)))
    col_match = maximum_bipartite_matching(graph, perm_type='column')
    matched_left = np.nonzero(col_match >= 0)[0]
    matched_right = col_match[matched_left]
    match1[py[matched_left], px[matched_left]] = 1
    match2[gy[matched_right], gx[matched_right]] = 1
    return match1, match2, float(len(matched_left)), 0.0


def binary_thin(img):
    """Zhang-Suen thinning of a binary map -> bool map; needs the native
    library (``bsds_matcher.py:123-131``)."""
    img = _as_u8(img).copy()
    lib = _get_lib()
    if lib is None:
        raise RuntimeError('binary_thin requires the native matcher (g++)')
    lib.binary_thin(_ptr(img), img.shape[0], img.shape[1])
    return img.astype(bool)
