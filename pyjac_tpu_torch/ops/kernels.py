"""Build, load and launch the hand-written CUDA kernels of the port.

The sources live in ``pyjac_tpu_torch/csrc/``; :func:`load` compiles
them with ``nvcc`` for ``sm_90a`` (one process per source, all at
once) and links them into a shared library with a plain C interface,
at first use, into ``build/kernels/`` beside the package (override
with ``PYJAC_TORCH_BUILD_DIR``), and loads it with ``ctypes``.  The
library name carries a hash of the sources and flags, so an edited
source is rebuilt and a finished build is reused.

Nothing here is imported or built when the package is imported: the
first CUDA launch builds.  Each launcher checks device, dtype, shape
and contiguity, allocates its outputs and scratch with ``torch.empty``
(K5 fills a part of an array its caller allocated: each of the two
reaction ranges of a split), launches
on the current CUDA stream, raises if the C entry returns a non-zero
``cudaError_t``, and adds one to ``launches[name]``.  There is no
fallback: a launcher given anything but CUDA tensors raises.
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
SOURCES = ('sparse_stage_a.cu', 'sparse_stage_b.cu', 'big_parts.cu',
           'big_cols_sparse.cu', 'big_cols_dense.cu', 'dense_fused.cu')
# device code the sources include (part of the build's hash)
HEADERS = ('kinetics.cuh', 'state_tile.cuh', 'columns.cuh')
ARCH = ('-gencode', 'arch=compute_90a,code=sm_90a')
# -fmad=false: no multiply-add contraction, so each kernel operation
# rounds like the plain version's separate torch ops (near equilibrium
# dy/dt magnifies an ulp of ln Kc ~1e9-fold)
NVCC_FLAGS = ARCH + ('-std=c++17', '-O3', '-fmad=false', '-Xcompiler',
                     '-fPIC', '-Xptxas', '-v')

# plain launch counters: one per kernel, bumped where it launches
launches = {'stage_a': 0, 'stage_b': 0, 'stage_b_x': 0, 'big_parts': 0,
            'big_cols_sparse': 0, 'big_cols_dense': 0, 'dense_fused': 0,
            'fused_f32': 0}

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
    vp, ci, cd, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
    lib.pyjac_stage_a_n_tables.argtypes = []
    lib.pyjac_stage_a_n_tables.restype = ci
    lib.pyjac_stage_a_tile_rows.argtypes = [vp]
    lib.pyjac_stage_a_tile_rows.restype = ci
    lib.pyjac_stage_a.argtypes = [vp, ci, vp, ci, cd, vp, vp, cll,
                                  vp, vp, vp, vp, vp, vp, ci, vp]
    lib.pyjac_stage_a.restype = ci
    lib.pyjac_stage_b.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, cll,
                                  vp]
    lib.pyjac_stage_b.restype = ci
    lib.pyjac_big_parts_n_tables.argtypes = []
    lib.pyjac_big_parts_n_tables.restype = ci
    lib.pyjac_big_parts.argtypes = [vp, ci, vp, ci, cd, vp, cll, ci, ci, ci,
                                    vp, vp]
    lib.pyjac_big_parts.restype = ci
    lib.pyjac_big_cols_sparse.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                          ci, cll, vp]
    lib.pyjac_big_cols_sparse.restype = ci
    lib.pyjac_big_cols_dense.argtypes = [vp] * 12 + [ci] * 6 + [cll, vp]
    lib.pyjac_big_cols_dense.restype = ci
    lib.pyjac_dense_fused_n_tables.argtypes = []
    lib.pyjac_dense_fused_n_tables.restype = ci
    lib.pyjac_dense_fused_tile_rows.argtypes = [vp]
    lib.pyjac_dense_fused_tile_rows.restype = ci
    lib.pyjac_dense_fused.argtypes = [vp, ci, vp, ci, cd, vp, vp, cll, vp, vp,
                                      vp, vp, ci, vp]
    lib.pyjac_dense_fused.restype = ci
    lib.pyjac_fused_f32.argtypes = lib.pyjac_dense_fused.argtypes
    lib.pyjac_fused_f32.restype = ci
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


def _table_ptrs(mod, prefixes, int_names, dtype, dev):
    """The table buffers of ``mod`` whose names start with one of
    ``prefixes``, in registration order (the C struct's), each checked:
    int32 where its name after the prefix is in ``int_names``, else
    ``dtype``.  Returns (their count, a ctypes array of their device
    pointers)."""
    tabs = [(k, t) for k, t in mod._buffers.items() if k[:3] in prefixes]
    for k, t in tabs:
        want = torch.int32 if k[3:] in int_names else dtype
        _check(type(mod).__name__ + '.' + k, t, t.shape, want, dev)
    return len(tabs), (ctypes.c_void_p * len(tabs))(
        *[t.data_ptr() for _, t in tabs])


def _kinetics_dims(mod) -> list:
    """The dims K1 and K4 / K3 share: {N, R, Sf, Sp, Pm, NT, NP, conp,
    has_frac, has_pm, has_spec} of ``mod``'s mechanism."""
    p = mod.packed
    NT, NP = p.cheb_coef.shape[1:]
    return [mod.N, mod.R, p.reac_sp.shape[1], p.prod_sp.shape[1],
            p.plog_lnP.shape[1], NT, NP, int(mod.conp), int(p.has_frac_nu),
            int(p.has_pres_mod), int(p.has_specific_pdep_sp)]


def stage_a(mod, y_t, P_t, plan=None) -> dict:
    """Launch the stage-A kernel K1 (``csrc/sparse_stage_a.cu``) for the
    tables of ``mod`` (a ``SparseJacobian``) on (N, B) states and a
    (1, B) pressure/density row: returns ``src``, ``col0``, ``f`` and
    ``post``.  ``plan``: a :func:`tile_plan` in place of the planner's
    own choice."""
    lib, args, out, _scratch = stage_a_args(mod, y_t, P_t, plan)
    with torch.cuda.device(y_t.device):
        err = lib.pyjac_stage_a(*args)
    _raise_on(err, 'stage A kernel')
    launches['stage_a'] += 1
    return out


def stage_a_args(mod, y_t, P_t, plan=None):
    """The checked arguments of K1's C entry for ``mod`` on (N, B) states
    and a (1, B) pressure/density row, under ``plan`` (default
    :func:`tile_plan`'s for the card): (the library, the argument list,
    the outputs it fills as {src, col0, f, post}, the scratch it uses:
    keep it until the launch)."""
    from .rates import _LN_PA_RU
    from .jacobian_big import PARTS_INT_TABLES
    from .jacobian_sparse import KERNEL_INT_TABLES
    dev, N, B = y_t.device, mod.N, y_t.shape[-1]
    _check('y_t', y_t, (N, B), F64, dev)
    _check('P_t', P_t, (1, B), F64, dev)
    mod.check_kernel_coverage(dev)
    n_tabs, ptrs = _table_ptrs(mod, ('kp_', 'kf_', 'ka_'),
                               PARTS_INT_TABLES + KERNEL_INT_TABLES, F64, dev)
    lib = load()
    if lib.pyjac_stage_a_n_tables() != n_tabs:
        raise RuntimeError('stage-A table count mismatch: %d in Python, %d '
                           'in the kernel' % (n_tabs,
                                              lib.pyjac_stage_a_n_tables()))
    dims = _kinetics_dims(mod) + [mod.S_eff]
    cdims = (ctypes.c_int * len(dims))(*dims)
    if plan is None:
        plan = tile_plan(mod, F64, B, _n_sm(dev))
    cplan = _plan_arg(plan, lib.pyjac_stage_a_tile_rows(cdims), 'stage A')
    out = {k: torch.empty((rows, B), dtype=F64, device=dev)
           for k, rows in (('src', mod.n_src), ('col0', N), ('f', N),
                           ('post', mod.n_post))}
    scratch = torch.empty((max(1, plan['scratch_elems']),), dtype=F64,
                          device=dev)
    args = [ptrs, n_tabs, cdims, len(dims), _LN_PA_RU, _ptr(y_t), _ptr(P_t),
            B, *(_ptr(out[k]) for k in ('src', 'col0', 'f', 'post')),
            _ptr(scratch), cplan, 4, _stream(dev)]
    return lib, args, out, scratch


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


def big_parts(mod, st_rows, roles, row0: int, rows: int, has_pm: bool):
    """Launch the K5 kernel (``csrc/big_parts.cu``) for the tables of
    ``mod`` (a ``BigJacobian``) on the pre-stage rows ``st_rows``
    (5 + 3N, B): writes reaction rows [row0, row0 + rows) of ``roles``
    (n_roles, R, B), with the pressure-modification machinery when
    ``has_pm``."""
    from .rates import _LN_PA_RU
    from .jacobian_big import PARTS_INT_TABLES
    dev, N, R, B = st_rows.device, mod.N, mod.R, st_rows.shape[-1]
    _check('st_rows', st_rows, (5 + 3 * N, B), F64, dev)
    _check('roles', roles, (mod.n_roles, R, B), F64, dev)
    if not (0 <= row0 and 0 < rows and row0 + rows <= R):
        raise ValueError('reaction rows [%d, %d) outside [0, %d)'
                         % (row0, row0 + rows, R))
    # the checked table pointers, kept on the module under the buffers'
    # addresses (a 654-class pass is host-bound), so a moved or
    # reassigned buffer is checked and passed anew
    tabs = [t for k, t in mod._buffers.items() if k.startswith('kp_')]
    key = ('big_parts', dev) + tuple(t.data_ptr() for t in tabs)
    cache = mod._launch_cache
    if key not in cache:
        names = [k for k in mod._buffers if k.startswith('kp_')]
        for k, t in zip(names, tabs):
            want = torch.int32 if k[3:] in PARTS_INT_TABLES else F64
            _check('BigJacobian.' + k, t, t.shape, want, dev)
        lib = load()
        if lib.pyjac_big_parts_n_tables() != len(tabs):
            raise RuntimeError(
                'K5 table count mismatch: %d in Python, %d in the kernel'
                % (len(tabs), lib.pyjac_big_parts_n_tables()))
        p = mod.packed
        NT, NP = p.cheb_coef.shape[1:]
        dims = [N, R, mod.Sf, mod.Sp, p.plog_lnP.shape[1], NT, NP,
                int(mod.conp), int(p.has_frac_nu)]
        cache.clear()
        cache[key] = (
            (ctypes.c_void_p * len(tabs))(*key[2:]),
            (ctypes.c_int * len(dims))(*dims), len(tabs), len(dims))
    ptrs, cdims, n_tabs, n_dims = cache[key]
    lib = load()
    with torch.cuda.device(dev):
        err = lib.pyjac_big_parts(ptrs, n_tabs, cdims, n_dims, _LN_PA_RU,
                                  _ptr(st_rows), B, row0, rows,
                                  int(bool(has_pm)), _ptr(roles),
                                  _stream(dev))
    _raise_on(err, 'K5 reaction-parts kernel')
    launches['big_parts'] += 1
    return roles


def stage_b_x(mod, p1, post):
    """Launch the K2x column kernel for the tables of ``mod`` (a
    ``SparseJacobian(fuse_gather=False)``): the (J, N, B) columns from
    the pre-gathered operand ``p1`` (J * Rmax, B) and stage A's post
    rows.  K2x is K6's kernel (``csrc/big_cols_sparse.cu``) on the
    module's CSR over operand rows."""
    return _cols_sparse(mod, p1, post, 'kx_', 'stage_b_x',
                        'K2x column kernel')


def big_cols_sparse(mod, p1c, post):
    """Launch the K6 kernel (``csrc/big_cols_sparse.cu``) for the tables
    of ``mod`` (a ``BigJacobian`` with ``sparse_cols``): the (J, N, B)
    columns from the compressed operand ``p1c`` (J * Rmax, B) and the
    post rows."""
    return _cols_sparse(mod, p1c, post, 'ks_', 'big_cols_sparse',
                        'K6 sparse column kernel')


def _cols_sparse(mod, p1, post, prefix, name, what):
    """K6's kernel on the CSR tables ``prefix + {ptr, src, coef}`` of
    ``mod`` over the rows of ``p1`` (J * Rmax, B); counts under
    ``name``."""
    dev, N, J, B = p1.device, mod.N, mod.J, p1.shape[-1]
    _check('p1', p1, (J * mod.Rmax, B), F64, dev)
    _check('post', post, (mod.n_post, B), F64, dev)
    ptr, src, coef = (getattr(mod, prefix + k) for k in ('ptr', 'src', 'coef'))
    owner = type(mod).__name__ + '.'
    for tname, t, want, shape in ((prefix + 'ptr', ptr, torch.int32,
                                   (J * N + 1,)),
                                  (prefix + 'src', src, torch.int32,
                                   src.shape),
                                  (prefix + 'coef', coef, F64, src.shape),
                                  ('inv_mw', mod.inv_mw, F64, (N,))):
        _check(owner + tname, t, shape, want, dev)
    lib = load()
    out = torch.empty((J, N, B), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pyjac_big_cols_sparse(
            _ptr(ptr), _ptr(src), _ptr(coef), _ptr(mod.inv_mw), _ptr(p1),
            _ptr(post), _ptr(out), N, mod.Rmax, int(mod.conp), B,
            _stream(dev))
    _raise_on(err, what)
    launches[name] += 1
    return out


def big_cols_dense(mod, roles, post):
    """Launch the K7 kernel (``csrc/big_cols_dense.cu``): the (J, N, B)
    columns of ``mod`` (a ``BigJacobian`` with ``sparse_cols=False``)
    from the role array and the post rows, through the per-column active
    reactions and their CSR (``jacobian_big.dense_active_tables``)."""
    dev, N, R, J, B = roles.device, mod.N, mod.R, mod.J, roles.shape[-1]
    _check('roles', roles, (mod.n_roles, R, B), F64, dev)
    _check('post', post, (mod.n_post, B), F64, dev)
    t = mod.tab('kd_')
    A = t['act'].shape[1]
    for name, want, shape in (('act', torch.int32, (J, A)),
                              ('ptr', torch.int32, (J * N + 1,)),
                              ('src', torch.int32, t['src'].shape),
                              ('coef', F64, t['src'].shape),
                              ('spf', torch.int32, (R, mod.Sf)),
                              ('spp', torch.int32, (R, mod.Sp)),
                              ('eff', F64, (R, N)),
                              ('pd', torch.int32, (R,))):
        _check('BigJacobian.kd_' + name, t[name], shape, want, dev)
    _check('BigJacobian.inv_mw', mod.inv_mw, (N,), F64, dev)
    lib = load()
    out = torch.empty((J, N, B), dtype=F64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pyjac_big_cols_dense(
            *(_ptr(t[k]) for k in ('act', 'ptr', 'src', 'coef', 'spf', 'spp',
                                   'eff', 'pd')),
            _ptr(mod.inv_mw), _ptr(roles), _ptr(post), _ptr(out), N, R,
            mod.Sf, mod.Sp, A, int(mod.conp), B, _stream(dev))
    _raise_on(err, 'K7 dense column kernel')
    launches['big_cols_dense'] += 1
    return out


def dense_fused(mod, y_t, P_t, plan=None):
    """Launch the K4 kernel (``csrc/dense_fused.cu``) for the tables of
    ``mod`` (a ``DenseJacobian``) on (N, B) states and a (1, B)
    pressure/density row: returns ``Jt`` (N, N, B), [column, row,
    batch], and dy/dt ``f`` (N, B).  ``plan``: a :func:`tile_plan`
    in place of the planner's own choice."""
    return _dense(mod, y_t, P_t, F64, 'pyjac_dense_fused', 'dense_fused',
                  'K4 dense fused kernel', plan)


def fused_f32(mod, y_t, P_t, plan=None):
    """Launch the K3 kernel, the float32 instantiation of K4's
    (``csrc/dense_fused.cu``), for the tables of ``mod`` (an
    ``F32Jacobian``) on float32 (N, B) states and a (1, B)
    pressure/density row: returns float32 ``Jt`` (N, N, B), [column, row,
    batch], and dy/dt ``f`` (N, B).  ``plan`` as :func:`dense_fused`'s."""
    return _dense(mod, y_t, P_t, torch.float32, 'pyjac_fused_f32',
                  'fused_f32', 'K3 f32 fused kernel', plan)


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


def tile_plan(mod, dtype, B: int, n_sm: int = 132, tile=None,
              placement=None) -> dict:
    """The launch plan of the tile kernel ``mod`` runs -- K1 for a
    ``SparseJacobian``, K4 for a ``DenseJacobian``, K3 for an
    ``F32Jacobian`` -- on B states in ``dtype``, on a card of ``n_sm``
    SMs.  A block keeps a tile of ``tile`` states' rows
    (:func:`stage_a_tile_rows`, :func:`dense_tile_rows`) on the SM: in
    dynamic shared memory (``placement`` 'shared', one block a tile)
    where one state's rows fit in :data:`SMEM_MAX`, the tile then as
    many states as fit, rounded down to whole 32 B sectors of the output
    rows where that leaves a sector's states; else in a slice of global
    scratch per block ('global': ``n_sm`` persistent blocks looping over
    the tiles, at most one sector's states a tile and as many as keep
    the slices within :data:`L2_SLICES`).  K1 takes at most as many
    states as leave a spare thread group, one more than N (phase 3 then
    runs the closure's sums; on the card 8 flagship states a tile beat
    12 by 5%: PERF.md).  ``tile`` / ``placement`` override the choice.
    Returns {tile, placement, grid, rows, smem_bytes, scratch_elems}."""
    from .jacobian_sparse import SparseJacobian
    itemsize = torch.empty((), dtype=dtype).element_size()
    dims = _kinetics_dims(mod)
    if isinstance(mod, SparseJacobian):
        rows = stage_a_tile_rows(dims[0], dims[1], dims[10])
        most = max(1, TILE_THREADS // (dims[0] + 1))
    else:
        rows = dense_tile_rows(*dims[:4], dims[10])
        most = TILE_THREADS
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


def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _plan_arg(plan, kernel_rows: int, what: str):
    """``plan`` as the C entries take it, after checking its rows
    against the kernel's own count."""
    if kernel_rows != plan['rows']:
        raise RuntimeError('%s: tile rows mismatch: %d in Python, %d in the '
                           'kernel' % (what, plan['rows'], kernel_rows))
    return (ctypes.c_longlong * 4)(
        plan['tile'], int(plan['placement'] == 'shared'), plan['grid'],
        plan['rows'])


def _dense(mod, y_t, P_t, dtype, entry, name, what, plan=None):
    """K4's kernel in ``dtype`` through the C entry ``entry``; counts
    under ``name``."""
    lib, args, Jt, f, _scratch = dense_args(mod, y_t, P_t, dtype, what, plan)
    with torch.cuda.device(y_t.device):
        err = getattr(lib, entry)(*args)
    _raise_on(err, what)
    launches[name] += 1
    return Jt, f


def dense_args(mod, y_t, P_t, dtype, what, plan=None):
    """The checked arguments of K4's / K3's C entry for ``mod`` on (N, B)
    states and a (1, B) pressure/density row in ``dtype``, under ``plan``
    (default :func:`tile_plan`'s for the card): (the library, the
    argument list, the outputs Jt and f it fills, the scratch it uses:
    keep it until the launch)."""
    from .rates import _LN_PA_RU
    from .jacobian_big import PARTS_INT_TABLES
    from .jacobian_dense import FUSED_INT_TABLES
    dev, N, B = y_t.device, mod.N, y_t.shape[-1]
    _check('y_t', y_t, (N, B), dtype, dev)
    _check('P_t', P_t, (1, B), dtype, dev)
    n_tabs, ptrs = _table_ptrs(mod, ('kp_', 'kf_'),
                               PARTS_INT_TABLES + FUSED_INT_TABLES, dtype, dev)
    lib = load()
    if lib.pyjac_dense_fused_n_tables() != n_tabs:
        raise RuntimeError('%s: table count mismatch: %d in Python, %d in '
                           'the kernel' % (what, n_tabs,
                                           lib.pyjac_dense_fused_n_tables()))
    dims = _kinetics_dims(mod)
    cdims = (ctypes.c_int * len(dims))(*dims)
    if plan is None:
        plan = tile_plan(mod, dtype, B, _n_sm(dev))
    cplan = _plan_arg(plan, lib.pyjac_dense_fused_tile_rows(cdims), what)
    Jt = torch.empty((N, N, B), dtype=dtype, device=dev)
    f = torch.empty((N, B), dtype=dtype, device=dev)
    scratch = torch.empty((max(1, plan['scratch_elems']),), dtype=dtype,
                          device=dev)
    args = [ptrs, n_tabs, cdims, len(dims), _LN_PA_RU, _ptr(y_t), _ptr(P_t),
            B, _ptr(Jt), _ptr(f), _ptr(scratch), cplan, 4, _stream(dev)]
    return lib, args, Jt, f, scratch
