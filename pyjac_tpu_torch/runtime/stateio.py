"""ctypes bindings for the native state-IO runtime (stateio.cpp).

The build step is the analog of the reference's library generation
(reference: pyjac/libgen/libgen.py:322-411): the shared library is
compiled on demand with g++ -O3 and cached in the port's build
directory; a pure NumPy fallback keeps the package functional on
compiler-less systems.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'stateio.cpp')

_lib = None
_lib_tried = False


def _build_library() -> Optional[str]:
    """Compile stateio.cpp -> libstateio_<hash>.so in the port's build
    directory (:func:`pyjac_tpu_torch.ops.kernels.build_dir`), never
    next to the source; the name hashes the source and the flags, and
    the library is written under a temporary name and renamed, so
    concurrent processes never load a half-written file."""
    import hashlib

    from ..ops.kernels import build_dir
    flags = ['-O3', '-std=c++17', '-shared', '-fPIC', '-pthread']
    with open(_SRC, 'rb') as fh:
        tag = hashlib.sha256(' '.join(flags).encode() + fh.read())
    out = build_dir() / ('libstateio_%s.so' % tag.hexdigest()[:16])
    if out.exists():
        return str(out)
    tmp = out.with_suffix('.so.tmp%d' % os.getpid())
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(['g++', *flags, '-o', str(tmp), _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning('stateio native build failed (%s); using the '
                    'NumPy fallback', e)
        return None
    return str(out)


def _get_lib():
    global _lib, _lib_tried
    if _lib is None and not _lib_tried:
        _lib_tried = True
        path = _build_library()
        if path is not None:
            lib = ctypes.CDLL(path)
            c_char_p = ctypes.c_char_p
            c_i64 = ctypes.c_int64
            dp = np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS')
            ip = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
            lib.stateio_count.argtypes = [c_char_p, c_i64]
            lib.stateio_count.restype = c_i64
            lib.stateio_load.argtypes = [c_char_p, c_i64, c_i64, dp]
            lib.stateio_load.restype = c_i64
            lib.stateio_build_states.argtypes = [dp, c_i64, c_i64, ip,
                                                 dp, dp, dp]
            lib.stateio_build_states.restype = ctypes.c_int
            lib.stateio_transpose.argtypes = [dp, c_i64, c_i64, dp]
            lib.stateio_transpose.restype = ctypes.c_int
            lib.stateio_density.argtypes = [dp, dp, dp, dp, c_i64, c_i64,
                                            dp]
            lib.stateio_density.restype = ctypes.c_int
            lib.stateio_save.argtypes = [c_char_p, dp, c_i64, c_i64]
            lib.stateio_save.restype = c_i64
            _lib = lib
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def load_raw(path: str, row_width: int,
             max_rows: Optional[int] = None) -> np.ndarray:
    """Read a data.bin of (t, T, P, Y...) rows -> (n, row_width)."""
    lib = _get_lib()
    if lib is None:
        raw = np.fromfile(path, dtype='<f8')
        n = raw.size // row_width
        if max_rows is not None:
            n = min(n, max_rows)
        return raw[:n * row_width].reshape(n, row_width)
    n = lib.stateio_count(path.encode(), row_width)
    if n < 0:
        raise IOError('cannot read ' + path)
    if max_rows is not None:
        n = min(n, max_rows)
    out = np.empty((n, row_width), dtype=np.float64)
    got = lib.stateio_load(path.encode(), row_width, n, out)
    if got != n:
        raise IOError('short read from %s: %d of %d rows' % (path, got, n))
    return out


def save_raw(path: str, rows: np.ndarray) -> None:
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    lib = _get_lib()
    if lib is None:
        rows.astype('<f8').tofile(path)
        return
    n = lib.stateio_save(path.encode(), rows, rows.shape[0],
                         rows.shape[1])
    if n != rows.shape[0]:
        raise IOError('short write to ' + path)


def build_states(raw: np.ndarray,
                 fwd_map) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Raw (t, T, P, Y-original...) rows -> (y, P, t) with
    y = [T, Y_pivoted_1..Y_{N-1}] (the species-mask application of
    reference read_initial_conditions.c:29-40)."""
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    n, w = raw.shape
    nsp = w - 3
    fwd = np.ascontiguousarray(fwd_map, dtype=np.int32)
    lib = _get_lib()
    if lib is None:
        y = np.concatenate([raw[:, 1:2], raw[:, 3:][:, fwd[:-1]]], axis=1)
        return y, raw[:, 2].copy(), raw[:, 0].copy()
    y = np.empty((n, nsp), dtype=np.float64)
    P = np.empty(n, dtype=np.float64)
    t = np.empty(n, dtype=np.float64)
    lib.stateio_build_states(raw, n, nsp, fwd, y, P, t)
    return y, P, t


def to_soa(aos: np.ndarray) -> np.ndarray:
    """(n, w) AoS -> (w, n) SoA (batch-minor for VPU lanes)."""
    aos = np.ascontiguousarray(aos, dtype=np.float64)
    lib = _get_lib()
    if lib is None:
        return np.ascontiguousarray(aos.T)
    n, w = aos.shape
    soa = np.empty((w, n), dtype=np.float64)
    lib.stateio_transpose(aos, n, w, soa)
    return soa


def density(T: np.ndarray, P: np.ndarray, Y_full: np.ndarray,
            mw: np.ndarray) -> np.ndarray:
    """CONV density precompute (reference
    read_initial_conditions.c:43-54)."""
    T = np.ascontiguousarray(T, dtype=np.float64)
    P = np.ascontiguousarray(P, dtype=np.float64)
    Y = np.ascontiguousarray(Y_full, dtype=np.float64)
    mw = np.ascontiguousarray(mw, dtype=np.float64)
    lib = _get_lib()
    if lib is None:
        inv = (Y / mw).sum(axis=-1)
        return P / (8314.4621 * T * inv)
    n, nsp = Y.shape
    rho = np.empty(n, dtype=np.float64)
    lib.stateio_density(T, P, Y, mw, n, nsp, rho)
    return rho
