"""Build, load and launch the hand-written CUDA kernels of the port.

The sources live in ``pyjac_tpu_torch/csrc/``; :func:`load` compiles
them with ``nvcc`` for ``sm_90a`` (one process per source, all at
once) and links them into a shared library with a plain C interface,
at first use, into ``build/kernels/`` beside the package (override
with ``PYJAC_TORCH_BUILD_DIR``), and loads it with ``ctypes``.  The
library name carries a hash of the sources and flags, so an edited
source is rebuilt and a finished build is reused.  Nothing is built
when the package is imported.

Every launch takes one path.  A kernel's tables and dims come from its
gatherer (the ``*_inputs`` functions), which checks each table's dtype
(int32 where the module class's ``INT_TABLES`` names it) and shape and
keeps them while the module's buffers are the same tensors; their
pointers are checked on the card once (:func:`table_ptrs`).  The tile
kernels K1, K4, K3 and dy/dt share one prologue (:func:`tile_args`,
driven by a record per kernel), the column kernels K2, K2x, K6 and K7
another (:func:`_launch_cols`); K5 and the LU have their own.  Each
checks its inputs, allocates its outputs, launches on the current CUDA
stream, raises if the C entry returns a non-zero ``cudaError_t`` and
adds one to ``launches[name]``; a launcher given anything but CUDA
tensors raises.  While a profiler records, each launch shows
``pyjac.kernels.prepare`` (with ``pyjac.kernels.plan`` and
``pyjac.kernels.alloc``) and ``pyjac.kernels.launch``.

K1, K2, K4, the dy/dt kernel and the integrator's LU are also PyTorch
operators (``torch.ops.pyjac_tpu_torch.*``), so that ``torch.export``
can trace a call and the live path and an exported program run the
same code.  Importing this module registers them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, NamedTuple

import torch

from ..profiling import span
from .common import F64, _tracing
from .rates import _LN_PA_RU

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'csrc'
SOURCES = ('sparse_stage_a.cu', 'sparse_stage_b.cu', 'big_parts.cu',
           'big_cols_sparse.cu', 'big_cols_dense.cu', 'dense_fused.cu',
           'batched_lu.cu', 'dydt.cu')
# device code the sources include (part of the build's hash)
HEADERS = ('kinetics.cuh', 'state_tile.cuh', 'columns.cuh',
           'dense_tables.cuh')
ARCH = ('-gencode', 'arch=compute_90a,code=sm_90a')
# -fmad=false: no multiply-add contraction, so each kernel operation
# rounds like the plain version's separate torch ops (near equilibrium
# dy/dt magnifies an ulp of ln Kc ~1e9-fold)
NVCC_FLAGS = ARCH + ('-std=c++17', '-O3', '-fmad=false', '-Xcompiler',
                     '-fPIC', '-Xptxas', '-v')

# plain launch counters: one per kernel, bumped where it launches
launches = {'stage_a': 0, 'stage_b': 0, 'stage_b_x': 0, 'big_parts': 0,
            'big_cols_sparse': 0, 'big_cols_dense': 0, 'dense_fused': 0,
            'fused_f32': 0, 'lu_factor': 0, 'lu_solve': 0, 'dydt': 0}

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


def _run_all(cmds):
    """Run the commands at once; raise on the first that fails."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
             for c in cmds]
    logs, failed = [], None
    for c, p in procs:
        out = p.communicate()[0]
        logs.append(out)
        if p.returncode != 0 and failed is None:
            failed = 'nvcc failed (%d):\n%s\n%s' % (p.returncode,
                                                   ' '.join(c), out)
    if failed:
        raise RuntimeError(failed)
    return ''.join(logs)


# the C entries' argument types; each returns an int (a count, or a
# cudaError_t), but pyjac_lu_state_bytes a long long
_vp, _ci, _cd, _cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
_ARGTYPES = {
    'pyjac_stage_a_n_tables': [],
    'pyjac_stage_a_tile_rows': [_vp],
    'pyjac_stage_a': [_vp, _ci, _vp, _ci, _cd, _vp, _vp, _cll, _vp, _vp, _vp,
                      _vp, _vp, _vp, _ci, _vp],
    'pyjac_stage_b': [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _cll, _vp],
    'pyjac_big_parts_n_tables': [],
    'pyjac_big_parts': [_vp, _ci, _vp, _ci, _cd, _vp, _cll, _ci, _ci, _ci,
                        _vp, _vp],
    'pyjac_big_cols_sparse': [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci,
                              _ci, _cll, _vp],
    'pyjac_big_cols_dense': [_vp] * 12 + [_ci] * 6 + [_cll, _vp],
    'pyjac_dense_fused_n_tables': [],
    'pyjac_dense_fused_tile_rows': [_vp],
    'pyjac_dense_fused': [_vp, _ci, _vp, _ci, _cd, _vp, _vp, _cll, _vp, _vp,
                          _vp, _vp, _ci, _vp],
    'pyjac_lu_state_bytes': [_ci],
    'pyjac_lu_factor': [_vp, _cll, _cll, _cll, _vp, _ci, _cll, _ci, _vp, _vp,
                        _vp, _vp],
    'pyjac_lu_solve': [_vp, _vp, _vp, _vp, _ci, _cll, _vp],
    'pyjac_dydt_tile_rows': [_vp],
    'pyjac_dydt': [_vp, _ci, _vp, _ci, _cd, _vp, _cll, _cll, _vp, _cll, _vp,
                   _cll, _cll, _vp, _vp, _ci, _vp],
}
_ARGTYPES['pyjac_fused_f32'] = _ARGTYPES['pyjac_dense_fused']


def load():
    """The kernels' shared library, built on first use: one nvcc per
    source, all started together, then one link."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs + [CSRC / x for x in HEADERS]:
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    out = build_dir() / ('libpyjac_kernels_%s.so' % tag)
    t0 = time.perf_counter()
    log = ''
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        objs = [out.parent / ('%s_%s_%d.o' % (s.stem, tag, os.getpid()))
                for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', str(o), str(s)]
                        for s, o in zip(srcs, objs)])
        tmp = out.with_suffix('.so.tmp%d' % os.getpid())
        log += _run_all([[nvcc, *ARCH, '-shared', '-o', str(tmp),
                          *map(str, objs)]])
        os.replace(tmp, out)
        for o in objs:
            o.unlink()
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _ARGTYPES.items():
        entry = getattr(lib, name)
        entry.argtypes = argtypes
        entry.restype = (ctypes.c_longlong if name == 'pyjac_lu_state_bytes'
                         else ctypes.c_int)
    build_info.update(seconds=time.perf_counter() - t0, library=str(out),
                      log=log)
    _lib = lib
    return lib


def _check(name, x, shape, dtype, device, contiguous=True):
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
    if contiguous and not x.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def _on_card(name, x):
    """Refuse an operator's input that is not a CUDA tensor (or a meta
    one, whose shapes alone a trace reads): the operators have no other
    implementation, and a caller on the CPU runs the plain versions."""
    if not isinstance(x, torch.Tensor) or x.device.type not in ('cuda',
                                                                 'meta'):
        raise ValueError('%s: expected a CUDA tensor, got %s' % (
            name, x.device if isinstance(x, torch.Tensor) else type(x)))


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _launch(entry, args, dev, name: str, what: str) -> None:
    """Call the C entry ``entry(*args)`` on ``dev`` under the span
    ``pyjac.kernels.launch``, raise if it returns an error, and count
    the launch under ``launches[name]``."""
    with span('pyjac.kernels.launch'), torch.cuda.device(dev):
        err = entry(*args)
    if err != 0:
        raise RuntimeError('%s: invalid dimensions' % what if err == -1 else
                           '%s: CUDA error %d' % (what, err))
    launches[name] += 1


def _tables(mod, names, dtype, shapes=None) -> list:
    """The buffers ``names`` of ``mod``, in that order, each checked on
    any device: int32 where the module's ``INT_TABLES`` names it, else
    ``dtype``, and of the shape ``shapes`` holds under its name, if
    any."""
    tabs = [mod._buffers[k] for k in names]
    for k, t in zip(names, tabs):
        want = (torch.int32 if k in mod.INT_TABLES else dtype,
                tuple((shapes or {}).get(k, t.shape)))
        if (t.dtype, tuple(t.shape)) != want:
            raise ValueError('%s.%s: expected %s %s, got %s %s' % (
                type(mod).__name__, k, *want, t.dtype, tuple(t.shape)))
    return tabs


def _prefixed(mod, prefixes) -> list:
    """The names of ``mod``'s buffers that start with one of
    ``prefixes``, in registration order (the C struct's)."""
    return [k for k in mod._buffers if k[:3] in prefixes]


def _module_inputs(mod, kernel, build):
    """``build()``, one kernel's (tables, dims) of ``mod``, kept on the
    module while its buffers are the same tensors (a move or a
    reassigned buffer builds anew; the kept tables hold their ids).
    Under a tracer the module's buffers are the tracer's stand-ins:
    built anew and not kept."""
    if _tracing():
        return build()
    ids = tuple(map(id, mod._buffers.values()))
    kept = mod.__dict__.setdefault('_kernel_inputs', {})
    hit = kept.get(kernel)
    if hit is None or hit[0] != ids:
        hit = kept[kernel] = (ids, build())
    return hit[1]


# checked table pointer arrays by the tables' identities (the tables
# held, so an id is not reused while kept): a launch of K1 passes ~50
_PTRS = {}


def table_ptrs(tabs, dtype, dev, what, n_tables=None):
    """A ctypes array of the device pointers of the tables ``tabs``, each
    checked once: on ``dev``, contiguous, int32 or ``dtype``; and, with
    ``n_tables``, as many as that C entry counts."""
    key = (dtype, dev, n_tables) + tuple(map(id, tabs))
    hit = _PTRS.get(key)
    if hit is None:
        for i, t in enumerate(tabs):
            _check('%s table %d' % (what, i), t, t.shape,
                   torch.int32 if t.dtype == torch.int32 else dtype, dev)
        n = len(tabs) if n_tables is None else getattr(load(), n_tables)()
        if n != len(tabs):
            raise RuntimeError('%s: table count mismatch: %d in Python, %d '
                               'in the kernel' % (what, len(tabs), n))
        if len(_PTRS) >= 16:
            _PTRS.clear()
        hit = _PTRS[key] = (list(tabs), (ctypes.c_void_p * len(tabs))(
            *[t.data_ptr() for t in tabs]))
    return hit[1]


def _kinetics_dims(mod) -> list:
    """The dims K1, K4 / K3 and K5 share: {N, R, Sf, Sp, Pm, NT, NP,
    conp, has_frac (K5's nine), has_pm, has_spec} of ``mod``'s
    mechanism."""
    p = mod.packed
    NT, NP = p.cheb_coef.shape[1:]
    return [mod.N, mod.R, p.reac_sp.shape[1], p.prod_sp.shape[1],
            p.plog_lnP.shape[1], NT, NP, int(mod.conp), int(p.has_frac_nu),
            int(p.has_pres_mod), int(p.has_specific_pdep_sp)]


def stage_a_inputs(mod):
    """K1's (tables, dims) of ``mod`` (a ``SparseJacobian``): the tables
    K5's ``kp_``, the closure's ``kf_``, then ``ka_``; the dims
    :func:`_kinetics_dims`, S_eff (the C entry's twelve), then the rows
    of the source stack and of the post block."""
    return _module_inputs(mod, 'stage_a', lambda: (
        _tables(mod, _prefixed(mod, ('kp_', 'kf_', 'ka_')), F64),
        _kinetics_dims(mod) + [mod.S_eff, mod.n_src, mod.n_post]))


def _csr_tables(mod, prefix: str) -> list:
    """The CSR ``prefix`` + {ptr, src, coef} of ``mod`` over (column,
    species row) into an operand's rows, then inv_mw, checked."""
    names = [prefix + k for k in ('ptr', 'src', 'coef')] + ['inv_mw']
    return _tables(mod, names, F64, {
        names[0]: (mod.J * mod.N + 1,), names[2]: mod._buffers[names[1]].shape,
        'inv_mw': (mod.N,)})


def stage_b_inputs(mod):
    """K2's (tables, dims) of ``mod`` (a ``SparseJacobian``): [col_ptr,
    col_src, col_coef, inv_mw] and [N, conp, n_src, n_post]."""
    return _module_inputs(mod, 'stage_b', lambda: (
        _csr_tables(mod, 'col_'), [mod.N, int(mod.conp), mod.n_src,
                                   mod.n_post]))


def dense_inputs(mod, dtype):
    """K4's / K3's (tables, dims) of ``mod`` in ``dtype``, which the
    dy/dt kernel takes too: the tables K5's ``kp_``, then ``kf_``; the
    dims :func:`_kinetics_dims`."""
    return _module_inputs(mod, ('dense', dtype), lambda: (
        _tables(mod, _prefixed(mod, ('kp_', 'kf_')), dtype),
        _kinetics_dims(mod)))


def parts_inputs(mod):
    """K5's (tables, dims) of ``mod`` (a ``BigJacobian``): the tables
    ``kp_``; the dims the leading nine of :func:`_kinetics_dims`."""
    return _module_inputs(mod, 'big_parts', lambda: (
        _tables(mod, _prefixed(mod, ('kp_',)), F64), _kinetics_dims(mod)[:9]))


def cols_sparse_inputs(mod, prefix: str):
    """K6's kernel's (tables, dims) of ``mod`` on its CSR ``prefix`` (K6:
    ``ks_``; K2x: ``kx_``): [ptr, src, coef, inv_mw] and [N, Rmax,
    conp]."""
    return _module_inputs(mod, prefix, lambda: (
        _csr_tables(mod, prefix), [mod.N, mod.Rmax, int(mod.conp)]))


def cols_dense_inputs(mod):
    """K7's (tables, dims) of ``mod`` (a ``BigJacobian`` with
    ``sparse_cols=False``): its ``kd_`` tables [act, ptr, src, coef,
    spf, spp, eff, pd] (``jacobian_big.dense_active_tables``), then
    inv_mw; [N, R, Sf, Sp, A (``act``'s width), conp]."""
    def build():
        N, R, J, A = mod.N, mod.R, mod.J, mod.kd_act.shape[1]
        names = ['kd_' + k for k in ('act', 'ptr', 'src', 'coef', 'spf',
                                     'spp', 'eff', 'pd')] + ['inv_mw']
        shapes = {'kd_act': (J, A), 'kd_ptr': (J * N + 1,),
                  'kd_coef': mod.kd_src.shape, 'kd_spf': (R, mod.Sf),
                  'kd_spp': (R, mod.Sp), 'kd_eff': (R, N), 'kd_pd': (R,),
                  'inv_mw': (N,)}
        return (_tables(mod, names, F64, shapes),
                [N, R, mod.Sf, mod.Sp, A, int(mod.conp)])
    return _module_inputs(mod, 'big_cols_dense', build)


def stage_a(mod, y_t, P_t, plan=None) -> dict:
    """Launch the stage-A kernel K1 (``csrc/sparse_stage_a.cu``) for the
    tables of ``mod`` (a ``SparseJacobian``) on (N, B) states and a
    (1, B) pressure/density row, through the operator
    ``pyjac_tpu_torch::stage_a``: returns ``src``, ``col0``, ``f`` and
    ``post``.  ``plan``: a :func:`tile_plan` in place of the planner's
    own choice."""
    _on_card('y_t', y_t)
    out = torch.ops.pyjac_tpu_torch.stage_a(*stage_a_inputs(mod), y_t, P_t,
                                            plan_ints(plan))
    return dict(zip(('src', 'col0', 'f', 'post'), out))


def stage_b(mod, src, post):
    """Launch the stage-B kernel (``csrc/sparse_stage_b.cu``): the
    (J, N, B) Jacobian columns from stage A's ``src`` and ``post``,
    through the operator ``pyjac_tpu_torch::stage_b``."""
    _on_card('src', src)
    return torch.ops.pyjac_tpu_torch.stage_b(*stage_b_inputs(mod), src,
                                             post)


def big_parts(mod, st_rows, roles, row0: int, rows: int, has_pm: bool):
    """Launch the K5 kernel (``csrc/big_parts.cu``) for the tables of
    ``mod`` (a ``BigJacobian``) on the pre-stage rows ``st_rows``
    (5 + 3N, B): writes reaction rows [row0, row0 + rows) of ``roles``
    (n_roles, R, B), with the pressure-modification machinery when
    ``has_pm``."""
    what = 'K5 reaction-parts kernel'
    dev, B = st_rows.device, st_rows.shape[-1]
    with span('pyjac.kernels.prepare'):
        tabs, dims = parts_inputs(mod)
        N, R = dims[:2]
        _check('st_rows', st_rows, (5 + 3 * N, B), F64, dev)
        _check('roles', roles, (mod.n_roles, R, B), F64, dev)
        if not (0 <= row0 and 0 < rows and row0 + rows <= R):
            raise ValueError('reaction rows [%d, %d) outside [0, %d)'
                             % (row0, row0 + rows, R))
        ptrs = table_ptrs(tabs, F64, dev, what, 'pyjac_big_parts_n_tables')
        lib = load()
    _launch(lib.pyjac_big_parts,
            (ptrs, len(tabs), (ctypes.c_int * len(dims))(*dims), len(dims),
             _LN_PA_RU, _ptr(st_rows), B, row0, rows, int(bool(has_pm)),
             _ptr(roles), _stream(dev)),
            dev, 'big_parts', what)
    return roles


def stage_b_x(mod, p1, post):
    """Launch the K2x column kernel for the tables of ``mod`` (a
    ``SparseJacobian(fuse_gather=False)``): the (J, N, B) columns from
    the pre-gathered operand ``p1`` (J * Rmax, B) and stage A's post
    rows.  K2x is K6's kernel (``csrc/big_cols_sparse.cu``) on the
    module's CSR over operand rows."""
    return _launch_cols('stage_b_x', *cols_sparse_inputs(mod, 'kx_'), p1,
                        (mod.J * mod.Rmax,), post, mod.n_post)


def big_cols_sparse(mod, p1c, post):
    """Launch the K6 kernel (``csrc/big_cols_sparse.cu``) for the tables
    of ``mod`` (a ``BigJacobian`` with ``sparse_cols``): the (J, N, B)
    columns from the compressed operand ``p1c`` (J * Rmax, B) and the
    post rows."""
    return _launch_cols('big_cols_sparse', *cols_sparse_inputs(mod, 'ks_'),
                        p1c, (mod.J * mod.Rmax,), post, mod.n_post)


def big_cols_dense(mod, roles, post):
    """Launch the K7 kernel (``csrc/big_cols_dense.cu``): the (J, N, B)
    columns of ``mod`` (a ``BigJacobian`` with ``sparse_cols=False``)
    from the role array and the post rows, through the per-column active
    reactions and their CSR (:func:`cols_dense_inputs`)."""
    return _launch_cols('big_cols_dense', *cols_dense_inputs(mod), roles,
                        (mod.n_roles, mod.R), post, mod.n_post)


def dense_fused(mod, y_t, P_t, plan=None):
    """Launch the K4 kernel (``csrc/dense_fused.cu``) for the tables of
    ``mod`` (a ``DenseJacobian``) on (N, B) states and a (1, B)
    pressure/density row, through the operator
    ``pyjac_tpu_torch::dense_fused``: returns ``Jt`` (N, N, B), [column,
    row, batch], and dy/dt ``f`` (N, B).  ``plan``: a :func:`tile_plan`
    in place of the planner's own choice."""
    _on_card('y_t', y_t)
    return tuple(torch.ops.pyjac_tpu_torch.dense_fused(
        *dense_inputs(mod, F64), y_t, P_t, plan_ints(plan)))


def fused_f32(mod, y_t, P_t, plan=None):
    """Launch the K3 kernel (``csrc/dense_fused.cu`` instantiated for
    float) for the tables of ``mod`` (an ``F32Jacobian``) on float32
    (N, B) states and a (1, B) pressure/density row: returns float32
    ``Jt`` (N, N, B), [column, row, batch], and dy/dt ``f`` (N, B).
    ``plan`` as :func:`dense_fused`'s.  K3 is no operator: no exported
    program calls it."""
    return _launch_tile('fused_f32', *dense_inputs(mod, torch.float32), y_t,
                        P_t, plan_ints(plan))


def dydt(mod, y_t, P_t, plan=None):
    """Launch the dy/dt kernel (``csrc/dydt.cu``) for the tables of
    ``mod`` (a ``DenseJacobian``: K4's) on (N, B) states ``y_t`` of any
    strides and a (1, B) pressure/density row, through the operator
    ``pyjac_tpu_torch::dydt``: returns f (N, B), laid out as ``y_t``
    (``torch.empty_like``), equal to K4's f bit for bit.  ``plan``: a
    :func:`tile_plan` with ``kernel='dydt'`` in place of the planner's
    own choice."""
    _on_card('y_t', y_t)
    return torch.ops.pyjac_tpu_torch.dydt(*dense_inputs(mod, F64), y_t, P_t,
                                          plan_ints(plan))


# the block of a state tile (csrc/state_tile.cuh TILE_THREADS: K1, K4,
# K3) and the dynamic shared memory one block may use on the H100 (227 KB)
TILE_THREADS = 512
SMEM_MAX = 232448
# bytes the global placement's live slices may take: most of the 50 MB L2,
# leaving room for the tables and the stores of J passing through
L2_SLICES = 40e6
# a row's stores are whole 32 B sectors when a tile holds a multiple of
# this
SECTOR = 32
# the most states a tile of the dy/dt kernel takes: at the flagship 16
# states a tile (32 thread groups, each a half warp) ran in 0.439 ms
# against 0.486 at 32, 0.505 at 24, 0.541 at 40 (the most shared memory
# holds, in whole sectors) and 0.544 at 8 (B = 32768, PERF.md): a smaller
# tile leaves L1 more of the SM, where the tables' loads wait
DYDT_TILE = 16


def dense_tile_rows(N: int, R: int, Sf: int, Sp: int,
                    has_spec: bool = True) -> int:
    """Rows of one state's tile in K4 / K3 (``tile_layout`` in
    ``csrc/dense_fused.cu``, which the launcher checks): y and P (N + 1),
    the state scalars (4), the state/thermo rows (5 + 3N, later also
    omega, domega and the closure's sums), the role array ((Sf + Sp + 6)
    R, less the xi_q rows without species-specific pdep), the post rows
    (4N + 2J + 3), h and dcp (2N); plus N staging rows where the role
    array's q..c_1 rows (4R) hold no column of N."""
    J = N - 1
    rows = (N + 1) + 4 + (5 + 3 * N) + (Sf + Sp + 5 + int(bool(has_spec))) \
        * R + (4 * N + 2 * J + 3) + 2 * N
    return rows + (N if 4 * R < N else 0)


def stage_a_tile_rows(N: int, R: int, has_spec: bool = True) -> int:
    """Rows of one state's tile in K1 (``stage_a_layout`` in
    ``csrc/sparse_stage_a.cu``, which the launcher checks): K4's less the
    slot roles, which K1 writes straight to its source stack: y and P
    (N + 1), the state scalars (4), the state/thermo rows (5 + 3N), the
    per-reaction rows q, dq_dT, c_u, c_1, psi_q and, with
    species-specific pdep, xi_q ((5 + has_spec) R), the post rows
    (4N + 2J + 3), h and dcp (2N); plus 3N rows of closure terms where
    the per-reaction rows are fewer."""
    J = N - 1
    per_rxn = (5 + int(bool(has_spec))) * R
    return (N + 1) + 4 + (5 + 3 * N) + per_rxn + (4 * N + 2 * J + 3) + \
        2 * N + (3 * N if 3 * N > per_rxn else 0)


def dydt_tile_rows(N: int, R: int) -> int:
    """Rows of one state's tile in the dy/dt kernel (``dydt_tile_layout``
    in ``csrc/state_tile.cuh``, which the launcher checks): y and P
    (N + 1), the state scalars (4), the state/thermo rows (5 + 3N, later
    also omega, dT/dt's per-species terms and the closure's sums), q (R),
    cp, h and dcp (3N)."""
    return (N + 1) + 4 + (5 + 3 * N) + R + 3 * N


def tile_plan(mod, dtype, B: int, n_sm: int = 132, tile=None,
              placement=None, kernel=None) -> dict:
    """The launch plan of the tile kernel ``mod`` runs -- K1 for a
    ``SparseJacobian``, K4 for a ``DenseJacobian``, K3 for an
    ``F32Jacobian``; with ``kernel='dydt'`` the dy/dt kernel on a
    ``DenseJacobian``'s tables -- on B states in ``dtype``, on a card of
    ``n_sm`` SMs.  A block keeps a tile of ``tile`` states' rows
    (:func:`stage_a_tile_rows`, :func:`dense_tile_rows`,
    :func:`dydt_tile_rows`) on the SM: in
    dynamic shared memory (``placement`` 'shared', one block a tile)
    where one state's rows fit in :data:`SMEM_MAX`, the tile then as
    many states as fit, rounded down to whole 32 B sectors of the output
    rows where that leaves a sector's states; else in a slice of global
    scratch per block ('global': ``n_sm`` persistent blocks looping over
    the tiles, at most one sector's states a tile and as many as keep
    the slices within :data:`L2_SLICES`).  K1 takes at most as many
    states as leave a spare thread group, one more than N (phase 3 then
    runs the closure's sums; on the card 8 flagship states a tile beat
    12 by 5%: PERF.md), the dy/dt kernel at most :data:`DYDT_TILE`.
    ``tile`` / ``placement`` override the choice.  Returns {tile, placement, grid, rows, smem_bytes, scratch_elems}."""
    return _plan(_kinetics_dims(mod), kernel or mod.TILE_KERNEL, dtype, B,
                 n_sm, tile, placement)


def _plan(dims, kernel: str, dtype, B: int, n_sm: int, tile=None,
          placement=None) -> dict:
    """:func:`tile_plan` from the kinetics dims leading ``dims`` of K1
    (``kernel`` 'stage_a'), of K4 / K3 ('dense_fused') or of the dy/dt
    kernel ('dydt'): what the operators plan at run time."""
    itemsize = dtype.itemsize
    most = TILE_THREADS
    if kernel == 'stage_a':
        rows = stage_a_tile_rows(dims[0], dims[1], dims[10])
        most = max(1, TILE_THREADS // (dims[0] + 1))
    elif kernel == 'dydt':
        rows = dydt_tile_rows(dims[0], dims[1])
        most = DYDT_TILE
    else:
        rows = dense_tile_rows(*dims[:4], dims[10])
    per_state = rows * itemsize
    group = SECTOR // itemsize
    fit = min(SMEM_MAX // per_state, most)
    if placement is None:
        placement = 'shared' if fit >= 1 else 'global'
    if placement not in ('shared', 'global'):
        raise ValueError('placement must be shared or global, got %r'
                         % (placement,))
    if tile is None:
        if placement == 'shared':
            tile = fit if fit < group else fit // group * group
        else:
            tile = max(1, min(group, int(L2_SLICES // (n_sm * per_state))))
    tile = int(tile)
    if not 1 <= tile <= TILE_THREADS:
        raise ValueError('a tile holds 1 to %d states, got %d'
                         % (TILE_THREADS, tile))
    n_tiles = -(-int(B) // tile)
    if placement == 'shared':
        smem = rows * tile * itemsize
        if smem > SMEM_MAX:
            raise ValueError('%d states of %d bytes exceed %d bytes of '
                             'shared memory' % (tile, per_state, SMEM_MAX))
        grid, scratch = n_tiles, 0
    else:
        smem, grid = 0, min(n_tiles, int(n_sm))
        scratch = grid * rows * tile
    return dict(tile=tile, placement=placement, grid=grid, rows=rows,
                smem_bytes=smem, scratch_elems=scratch)


def lu_state_bytes(N: int) -> int:
    """Shared memory one state takes in the LU factor
    (``lu_state_bytes`` in ``csrc/batched_lu.cu``, which the launcher
    checks): the N x N matrix with an odd row stride, two pivot values
    and their reciprocals, two row orders and N pivots."""
    return N * (N | 1) * 8 + 4 * 8 + 3 * N * 4


# the widest iteration matrix one block of the LU factor holds on chip
LU_MAX_N = max(n for n in range(1, 256) if lu_state_bytes(n) <= SMEM_MAX)


def lu_on_chip(x) -> bool:
    """Whether the LU kernels take the matrices of ``x`` (a stage
    Jacobian or a right-hand side, N its last dimension): on the card,
    up to :data:`LU_MAX_N`.  Elsewhere the integrator forms W in torch
    and the library factors it."""
    return x.device.type == 'cuda' and x.shape[-1] <= LU_MAX_N


def lu_tile(N: int) -> int:
    """States a block of the LU factor keeps, ``LU_WARPS`` warps each
    (``csrc/batched_lu.cu``): two where they fit one block's shared
    memory, else one.  Two beat one and four at the flagship on the card
    (PERF.md): half a 32 B sector of a batch-minor J a load, and as many
    states resident on an SM.  A state's result does not depend on its
    tile."""
    return 2 if 2 * lu_state_bytes(N) <= SMEM_MAX else 1


def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def plan_ints(plan):
    """A :func:`tile_plan` as the operators take it: [tile, shared (1) or
    global (0), grid, rows, scratch_elems]; None stays None (the launch
    plans for itself)."""
    if plan is None:
        return None
    return [plan['tile'], int(plan['placement'] == 'shared'), plan['grid'],
            plan['rows'], plan['scratch_elems']]


class _Tile(NamedTuple):
    """How a tile kernel (K1, K4, K3, dy/dt) is launched.  Its key in
    :data:`_TILES` is its ``launches`` name and its kernel in
    :func:`_plan`; its C entry is ``pyjac_<key>``, taking ``n_dims``
    dims.  ``n_tables`` and ``tile_rows`` name the C entries that count
    its tables and a state's tile rows; ``strided``: its states and
    outputs may have any strides (each pointer followed by its two);
    ``outputs(dims, y_t)``: its outputs, new (also the operator's fake
    implementation); ``what``: its name in errors."""
    n_tables: str
    tile_rows: str
    dtype: torch.dtype
    n_dims: int
    strided: bool
    outputs: Callable
    what: str


def _dense_outputs(dims, y_t):
    N, B = dims[0], y_t.shape[-1]
    return y_t.new_empty((N, N, B)), y_t.new_empty((N, B))


_TILES = {
    'stage_a': _Tile(
        'pyjac_stage_a_n_tables', 'pyjac_stage_a_tile_rows', F64, 12, False,
        lambda dims, y_t: tuple(y_t.new_empty((rows, y_t.shape[-1]))
                                for rows in (dims[12], dims[0], dims[0],
                                             dims[13])),
        'stage A kernel'),
    'dense_fused': _Tile(
        'pyjac_dense_fused_n_tables', 'pyjac_dense_fused_tile_rows', F64, 11,
        False, _dense_outputs, 'K4 dense fused kernel'),
    'fused_f32': _Tile(
        'pyjac_dense_fused_n_tables', 'pyjac_dense_fused_tile_rows',
        torch.float32, 11, False, _dense_outputs, 'K3 f32 fused kernel'),
    'dydt': _Tile(
        'pyjac_dense_fused_n_tables', 'pyjac_dydt_tile_rows', F64, 11, True,
        lambda dims, y_t: torch.empty_like(y_t), 'dy/dt kernel'),
}


def tile_args(kernel: str, tabs, dims, y_t, P_t, plan=None):
    """Everything a launch of the tile kernel ``kernel`` (a key of
    :data:`_TILES`) passes, checked, for its gatherer's tables and dims
    under ``plan`` (:func:`plan_ints`; default the planner's for the
    card): (the C entry, the arguments, the outputs it fills, the
    scratch it uses: keep it until the launch)."""
    k = _TILES[kernel]
    dev, B = y_t.device, y_t.shape[-1]
    _check('y_t', y_t, (dims[0], B), k.dtype, dev, not k.strided)
    _check('P_t', P_t, (1, B), k.dtype, dev)
    ptrs = table_ptrs(tabs, k.dtype, dev, k.what, k.n_tables)
    lib = load()
    cdims = (ctypes.c_int * k.n_dims)(*dims[:k.n_dims])
    if plan is None:
        with span('pyjac.kernels.plan'):
            plan = plan_ints(_plan(dims, kernel, k.dtype, B, _n_sm(dev)))
    rows = getattr(lib, k.tile_rows)(cdims)
    if rows != plan[3]:
        raise RuntimeError('%s: tile rows mismatch: %d in Python, %d in the '
                           'kernel' % (k.what, plan[3], rows))
    with span('pyjac.kernels.alloc'):
        out = k.outputs(dims, y_t)
        scratch = torch.empty((max(1, plan[4]),), dtype=k.dtype, device=dev)

    def ref(x):  # a pointer, with its strides where they may be any
        return (_ptr(x), *x.stride()) if k.strided else (_ptr(x),)
    outs = out if isinstance(out, tuple) else (out,)
    args = [ptrs, len(tabs), cdims, k.n_dims, _LN_PA_RU, *ref(y_t),
            _ptr(P_t), B, *(a for o in outs for a in ref(o)), _ptr(scratch),
            (ctypes.c_longlong * 4)(*plan[:4]), 4, _stream(dev)]
    return getattr(lib, 'pyjac_' + kernel), args, out, scratch


def _launch_tile(kernel: str, tabs, dims, y_t, P_t, plan=None):
    """The tile kernel ``kernel`` launched and counted: its outputs (the
    operators' CUDA implementation)."""
    with span('pyjac.kernels.prepare'):
        entry, args, out, _scratch = tile_args(kernel, tabs, dims, y_t,
                                               P_t, plan)
    _launch(entry, args, y_t.device, kernel, _TILES[kernel].what)
    return out


# the column kernels by their ``launches`` name: (C entry, the leading
# dims it takes, what it is)
_COLS = {'stage_b': ('pyjac_stage_b', 2, 'stage B kernel'),
         'stage_b_x': ('pyjac_big_cols_sparse', 3, 'K2x column kernel'),
         'big_cols_sparse': ('pyjac_big_cols_sparse', 3,
                             'K6 sparse column kernel'),
         'big_cols_dense': ('pyjac_big_cols_dense', 6,
                            'K7 dense column kernel')}


def _launch_cols(kernel: str, tabs, dims, x, x_rows, post, n_post: int):
    """The column kernel ``kernel`` on the tables and dims of its gatherer,
    an operand ``x`` of ``x_rows`` rows and ``n_post`` post rows, counted:
    the (J, N, B) columns."""
    entry, n_dims, what = _COLS[kernel]
    dev, N, B = x.device, dims[0], x.shape[-1]
    with span('pyjac.kernels.prepare'):
        _check(what + ' operand', x, (*x_rows, B), F64, dev)
        _check('post', post, (n_post, B), F64, dev)
        ptrs = table_ptrs(tabs, F64, dev, what)
        lib = load()
        with span('pyjac.kernels.alloc'):
            out = torch.empty((N - 1, N, B), dtype=F64, device=dev)
    _launch(getattr(lib, entry), (*ptrs, _ptr(x), _ptr(post), _ptr(out),
                                  *dims[:n_dims], B, _stream(dev)),
            dev, kernel, what)
    return out


# ---------------------------------------------------------------------------
# the operators (what torch.export traces and an exported program
# calls); one implementation each, for CUDA.  Defined
# through torch.library.Library rather than custom_op, whose Python
# wrappers (device dispatch, autograd) every call would pay: a pass at a
# small batch is bound by the host.
# ---------------------------------------------------------------------------

_OPS = torch.library.Library('pyjac_tpu_torch', 'DEF')
_OPS.define('stage_a(Tensor[] tables, int[] dims, Tensor y_t, Tensor P_t, '
            'int[]? plan=None) -> (Tensor, Tensor, Tensor, Tensor)')
_OPS.define('stage_b(Tensor[] tables, int[] dims, Tensor src, Tensor post) '
            '-> Tensor')
_OPS.define('dense_fused(Tensor[] tables, int[] dims, Tensor y_t, '
            'Tensor P_t, int[]? plan=None) -> (Tensor, Tensor)')
_OPS.define('lu_factor(Tensor J, Tensor s) -> (Tensor, Tensor, Tensor)')
_OPS.define('lu_solve(Tensor LU, Tensor piv, Tensor rhs) -> Tensor')
_OPS.define('dydt(Tensor[] tables, int[] dims, Tensor y_t, Tensor P_t, '
            'int[]? plan=None) -> Tensor')


def _stage_b_op(tables, dims, src, post):
    """K2, counted: the (J, N, B) columns from :func:`stage_b_inputs`."""
    return _launch_cols('stage_b', tables, dims, src, (dims[2],), post,
                        dims[3])


def _tile_fake(kernel: str, tables, dims, y_t, P_t, plan=None):
    return _TILES[kernel].outputs(dims, y_t)


def _lu_factor_op(J, s):
    """The LU factor, counted: W_b = I - s_b J_b of the (B, N, N) stage
    Jacobians ``J`` (any strides) and the (B,) scales ``s``, formed as
    the kernel loads J.  Returns LU (B, N, N) (L below the diagonal, U on
    and above it), the 1-based pivots (B, N) int32 and ok (B,) bool, as
    ``torch.linalg.lu_factor_ex`` would, :func:`lu_tile` states a
    block."""
    dev = J.device
    with span('pyjac.kernels.prepare'):
        B, N = J.shape[0], J.shape[-1]
        _on_card('J', J)
        if J.dtype != F64 or tuple(J.shape) != (B, N, N):
            raise ValueError('J: expected float64 (B, N, N), got %s %s'
                             % (J.dtype, tuple(J.shape)))
        if N > LU_MAX_N:
            raise ValueError('N = %d exceeds the %d one block of the LU '
                             'factor holds' % (N, LU_MAX_N))
        _check('s', s, (B,), F64, dev)
        lib = load()
        if lib.pyjac_lu_state_bytes(N) != lu_state_bytes(N):
            raise RuntimeError('LU factor: state bytes mismatch: %d in '
                               'Python, %d in the kernel'
                               % (lu_state_bytes(N),
                                  lib.pyjac_lu_state_bytes(N)))
        with span('pyjac.kernels.alloc'):
            LU = torch.empty((B, N, N), dtype=F64, device=dev)
            piv = torch.empty((B, N), dtype=torch.int32, device=dev)
            ok = torch.empty((B,), dtype=torch.bool, device=dev)
    _launch(lib.pyjac_lu_factor,
            (_ptr(J), *J.stride(), _ptr(s), N, B,
             lu_tile(N), _ptr(LU), _ptr(piv), _ptr(ok), _stream(dev)),
            dev, 'lu_factor', 'LU factor kernel')
    return LU, piv, ok


def _lu_solve_op(LU, piv, rhs):
    """The LU solve, counted: x (B, N) with W x = ``rhs`` from the
    factor's LU and pivots."""
    dev = rhs.device
    with span('pyjac.kernels.prepare'):
        B, N = rhs.shape
        _check('rhs', rhs, (B, N), F64, dev)
        _check('LU', LU, (B, N, N), F64, dev)
        _check('piv', piv, (B, N), torch.int32, dev)
        lib = load()
        with span('pyjac.kernels.alloc'):
            x = torch.empty((B, N), dtype=F64, device=dev)
    _launch(lib.pyjac_lu_solve,
            (_ptr(LU), _ptr(piv), _ptr(rhs), _ptr(x), N, B, _stream(dev)),
            dev, 'lu_solve', 'LU solve kernel')
    return x


for _name in ('stage_a', 'dense_fused', 'dydt'):
    _OPS.impl(_name, functools.partial(_launch_tile, _name), 'CUDA')
    torch.library.register_fake('pyjac_tpu_torch::' + _name,
                                functools.partial(_tile_fake, _name),
                                lib=_OPS)
_OPS.impl('stage_b', _stage_b_op, 'CUDA')
_OPS.impl('lu_factor', _lu_factor_op, 'CUDA')
_OPS.impl('lu_solve', _lu_solve_op, 'CUDA')


@torch.library.register_fake('pyjac_tpu_torch::stage_b', lib=_OPS)
def _(tables, dims, src, post):
    return src.new_empty((dims[0] - 1, dims[0], src.shape[-1]))


@torch.library.register_fake('pyjac_tpu_torch::lu_factor', lib=_OPS)
def _(J, s):
    B, N = J.shape[0], J.shape[-1]
    return (J.new_empty((B, N, N)), J.new_empty((B, N), dtype=torch.int32),
            J.new_empty((B,), dtype=torch.bool))


@torch.library.register_fake('pyjac_tpu_torch::lu_solve', lib=_OPS)
def _(LU, piv, rhs):
    return rhs.new_empty(rhs.shape)
