"""Build, load and launch the hand-written CUDA kernels of the port.

The sources live in ``pyjac_tpu_torch/csrc/``; :func:`load` compiles
them with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, into ``build/kernels/`` beside the package
(override with ``PYJAC_TORCH_BUILD_DIR``), and loads it with
``ctypes``.  The library name carries a hash of the sources and flags,
so an edited source is rebuilt and a finished build is reused.

Nothing here is imported or built when the package is imported: the
first CUDA launch builds.  Each launcher checks device, dtype, shape
and contiguity, allocates its outputs and scratch with ``torch.empty``,
launches on the current CUDA stream, raises if the C entry returns a
non-zero ``cudaError_t``, and adds one to ``launches[name]``.  There is
no fallback: a launcher given anything but CUDA tensors raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from .common import F64

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
SOURCES = ('sparse_stage_a.cu', 'sparse_stage_b.cu')
# -fmad=false: no multiply-add contraction, so each kernel operation
# rounds like the plain version's separate torch ops (near equilibrium
# dy/dt magnifies an ulp of ln Kc ~1e9-fold); the kernels are bound by
# memory traffic, not by flops
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

# plain launch counters: one per kernel, bumped where it launches
launches = {'stage_a': 0, 'stage_b': 0}

# what the last build did: seconds, library path, nvcc's output
build_info = {}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build_dir() -> pathlib.Path:
    env = os.environ.get('PYJAC_TORCH_BUILD_DIR')
    if env:
        return pathlib.Path(env)
    return CSRC.parent.parent / 'build' / 'kernels'


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, 'bin', 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels of pyjac_tpu_torch are built from '
                       'source at first use')


def load():
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = build_dir() / ('libpyjac_sparse_%s.so' % h.hexdigest()[:16])
    t0 = time.perf_counter()
    log = ''
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix('.so.tmp%d' % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, srcs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError('nvcc failed (%d):\n%s\n%s' % (
                res.returncode, ' '.join(cmd), log))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    vp, ci, cd, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
    lib.pyjac_stage_a_n_tables.argtypes = []
    lib.pyjac_stage_a_n_tables.restype = ci
    lib.pyjac_stage_a.argtypes = [vp, ci, vp, ci, cd, vp, vp, cll,
                                  vp, vp, vp, vp, vp, vp]
    lib.pyjac_stage_a.restype = ci
    lib.pyjac_stage_b.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, cll,
                                  vp]
    lib.pyjac_stage_b.restype = ci
    build_info.update(seconds=time.perf_counter() - t0, library=str(out),
                      log=log)
    _lib = lib
    return lib


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor) or x.device.type != 'cuda':
        raise ValueError('%s: expected a CUDA tensor, got %s' % (
            name, x.device if isinstance(x, torch.Tensor) else type(x)))
    if x.device != device:
        raise ValueError('%s on %s, expected %s' % (name, x.device, device))
    if x.dtype != dtype:
        raise ValueError('%s: expected %s, got %s' % (name, dtype, x.dtype))
    if tuple(x.shape) != tuple(shape):
        raise ValueError('%s: expected shape %s, got %s' % (
            name, tuple(shape), tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def _raise_on(err, what):
    if err != 0:
        msg = ('%s: invalid dimensions' % what if err == -1 else
               '%s: CUDA error %d' % (what, err))
        raise RuntimeError(msg)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def stage_a(mod, y_t, P_t) -> dict:
    """Launch the stage-A kernel (``csrc/sparse_stage_a.cu``) for the
    tables of ``mod`` (a ``SparseJacobian``) on (N, B) states and a
    (1, B) pressure/density row."""
    from .rates import _LN_PA_RU
    from .jacobian_sparse import STAGE_A_INT_TABLES
    dev, N, B = y_t.device, mod.N, y_t.shape[-1]
    _check('y_t', y_t, (N, B), F64, dev)
    _check('P_t', P_t, (1, B), F64, dev)
    mod.check_kernel_coverage(dev)
    # the ka_ buffers, in registration order = the C struct's order
    names = [k for k in mod._buffers if k.startswith('ka_')]
    tabs = [mod._buffers[k] for k in names]
    for k, t in zip(names, tabs):
        want = torch.int32 if k[3:] in STAGE_A_INT_TABLES else F64
        _check('SparseJacobian.' + k, t, t.shape, want, dev)
    lib = load()
    if lib.pyjac_stage_a_n_tables() != len(tabs):
        raise RuntimeError('stage-A table count mismatch: %d in Python, %d '
                           'in the kernel' % (len(tabs),
                                              lib.pyjac_stage_a_n_tables()))
    packed = mod.packed
    dims = [N, mod.R, mod.Sf, mod.Sp, mod.S_eff, int(mod.conp),
            int(bool(packed.troe_has_T2.any()))]
    src = torch.empty((mod.n_src, B), dtype=F64, device=dev)
    col0 = torch.empty((N, B), dtype=F64, device=dev)
    f = torch.empty((N, B), dtype=F64, device=dev)
    post = torch.empty((mod.n_post, B), dtype=F64, device=dev)
    scratch = torch.empty((7 * N, B), dtype=F64, device=dev)
    ptrs = (ctypes.c_void_p * len(tabs))(*[t.data_ptr() for t in tabs])
    cdims = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(dev):
        err = lib.pyjac_stage_a(ptrs, len(tabs), cdims, len(dims),
                                _LN_PA_RU, _ptr(y_t), _ptr(P_t), B,
                                _ptr(src), _ptr(col0), _ptr(f), _ptr(post),
                                _ptr(scratch), _stream(dev))
    _raise_on(err, 'stage A kernel')
    launches['stage_a'] += 1
    return dict(src=src, col0=col0, f=f, post=post)


def stage_b(mod, src, post):
    """Launch the stage-B kernel (``csrc/sparse_stage_b.cu``): the
    (J, N, B) Jacobian columns from stage A's ``src`` and ``post``."""
    dev, N, J, B = src.device, mod.N, mod.J, src.shape[-1]
    _check('src', src, (mod.n_src, B), F64, dev)
    _check('post', post, (mod.n_post, B), F64, dev)
    for name, want in (('col_ptr', torch.int32), ('col_src', torch.int32),
                       ('col_coef', F64), ('inv_mw', F64)):
        t = getattr(mod, name)
        _check('SparseJacobian.' + name, t, t.shape, want, dev)
    lib = load()
    out = torch.empty((J, N, B), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pyjac_stage_b(_ptr(mod.col_ptr), _ptr(mod.col_src),
                                _ptr(mod.col_coef), _ptr(mod.inv_mw),
                                _ptr(src), _ptr(post), _ptr(out), N,
                                int(mod.conp), B, _stream(dev))
    _raise_on(err, 'stage B kernel')
    launches['stage_b'] += 1
    return out
