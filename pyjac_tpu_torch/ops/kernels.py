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
fallback: a launcher given anything but CUDA tensors raises.  While a
profiler records, each launch shows two spans (``profiling.span``):
``pyjac.kernels.prepare`` (the checks, table pointers and library, with
the children ``pyjac.kernels.plan``, where the launcher plans the tiles,
and ``pyjac.kernels.alloc``, where it allocates outputs and scratch) and
``pyjac.kernels.launch`` (the C entry's call, :func:`_launch`).

K1, K2 and K4, the kernels :mod:`pyjac_tpu_torch.libgen` exports, are
also registered as PyTorch operators (``torch.ops.pyjac_tpu_torch.
stage_a``, ``stage_b``, ``dense_fused``; :class:`torch.library.Library`)
taking their tables as a list of tensors, their dimensions as a list of
ints and, for K1 and K4, an optional tile plan, so that ``torch.export``
can trace a call: their fake implementations give the output shapes from
the dimensions and the batch, and their one implementation, for CUDA, is
the launch, planning its tiles from the batch at run time unless given a
plan.  :func:`stage_a`, :func:`stage_b` and :func:`dense_fused` always go
through them, so the live path and an exported program run the same
code.  A module's tables and dims are gathered once
(:func:`stage_a_inputs`, :func:`stage_b_inputs`, :func:`dense_inputs`)
and their pointers checked once (:func:`table_ptrs`).  The integrator's
batched LU (``csrc/batched_lu.cu``) is registered likewise, as
``pyjac_tpu_torch::lu_factor`` and ``::lu_solve``: it takes every
iteration matrix of width up to :data:`LU_MAX_N` on the card
(:func:`lu_on_chip`), called by ``integrate.lu_factor`` /
``lu_solve``.  So is the integrator's dy/dt kernel (``csrc/dydt.cu``),
as ``pyjac_tpu_torch::dydt`` (:func:`dydt`: K4's tables and phases cut
down to f, states of any strides).  Importing this module registers the
operators.
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

from ..profiling import span
from .common import F64, _tracing

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
    lib.pyjac_lu_state_bytes.argtypes = [ci]
    lib.pyjac_lu_state_bytes.restype = cll
    lib.pyjac_lu_factor.argtypes = [vp, cll, cll, cll, vp, ci, cll, ci, vp,
                                    vp, vp, vp]
    lib.pyjac_lu_factor.restype = ci
    lib.pyjac_lu_solve.argtypes = [vp, vp, vp, vp, ci, cll, vp]
    lib.pyjac_lu_solve.restype = ci
    lib.pyjac_dydt_tile_rows.argtypes = [vp]
    lib.pyjac_dydt_tile_rows.restype = ci
    lib.pyjac_dydt.argtypes = [vp, ci, vp, ci, cd, vp, cll, cll, vp, cll, vp,
                               cll, cll, vp, vp, ci, vp]
    lib.pyjac_dydt.restype = ci
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


def _raise_on(err, what):
    if err != 0:
        msg = ('%s: invalid dimensions' % what if err == -1 else
               '%s: CUDA error %d' % (what, err))
        raise RuntimeError(msg)


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
    _raise_on(err, what)
    launches[name] += 1


def _module_tables(mod, prefixes, int_names, dtype) -> list:
    """The table buffers of ``mod`` whose names start with one of
    ``prefixes``, in registration order (the C struct's), each checked
    on any device: int32 where its name after the prefix is in
    ``int_names``, else ``dtype``."""
    tabs = [(k, t) for k, t in mod._buffers.items() if k[:3] in prefixes]
    for k, t in tabs:
        want = torch.int32 if k[3:] in int_names else dtype
        if t.dtype != want:
            raise ValueError('%s.%s: expected %s, got %s' % (
                type(mod).__name__, k, want, t.dtype))
    return [t for _, t in tabs]


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


def table_ptrs(tabs, dtype, dev, what):
    """A ctypes array of the device pointers of the tables ``tabs``, each
    checked once: on ``dev``, contiguous, int32 or ``dtype``."""
    key = (dtype, dev) + tuple(map(id, tabs))
    hit = _PTRS.get(key)
    if hit is None:
        for i, t in enumerate(tabs):
            _check('%s table %d' % (what, i), t, t.shape,
                   torch.int32 if t.dtype == torch.int32 else dtype, dev)
        if len(_PTRS) >= 16:
            _PTRS.clear()
        hit = _PTRS[key] = (list(tabs), (ctypes.c_void_p * len(tabs))(
            *[t.data_ptr() for t in tabs]))
    return hit[1]


def _kinetics_dims(mod) -> list:
    """The dims K1 and K4 / K3 share: {N, R, Sf, Sp, Pm, NT, NP, conp,
    has_frac, has_pm, has_spec} of ``mod``'s mechanism."""
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
    from .jacobian_big import PARTS_INT_TABLES
    from .jacobian_sparse import KERNEL_INT_TABLES
    return _module_inputs(mod, 'stage_a', lambda: (
        _module_tables(mod, ('kp_', 'kf_', 'ka_'),
                       PARTS_INT_TABLES + KERNEL_INT_TABLES, F64),
        _kinetics_dims(mod) + [mod.S_eff, mod.n_src, mod.n_post]))


def stage_b_inputs(mod):
    """K2's (tables, dims) of ``mod`` (a ``SparseJacobian``): [col_ptr,
    col_src, col_coef, inv_mw] and [N, conp, n_src, n_post]."""
    return _module_inputs(mod, 'stage_b', lambda: (
        [mod.col_ptr, mod.col_src, mod.col_coef, mod.inv_mw],
        [mod.N, int(mod.conp), mod.n_src, mod.n_post]))


def dense_inputs(mod, dtype):
    """K4's / K3's (tables, dims) of ``mod`` in ``dtype``: the tables
    K5's ``kp_``, then ``kf_``; the dims :func:`_kinetics_dims`."""
    from .jacobian_big import PARTS_INT_TABLES
    from .jacobian_dense import FUSED_INT_TABLES
    return _module_inputs(mod, ('dense', dtype), lambda: (
        _module_tables(mod, ('kp_', 'kf_'),
                       PARTS_INT_TABLES + FUSED_INT_TABLES, dtype),
        _kinetics_dims(mod)))


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


def stage_a_args(tabs, dims, y_t, P_t, plan=None):
    """Everything a K1 launch passes, checked, for the tables and dims of
    :func:`stage_a_inputs` under ``plan`` (:func:`plan_ints`; default
    :func:`tile_plan`'s for the card): (the library, the argument list,
    the outputs it fills as {src, col0, f, post}, the scratch it uses:
    keep it until the launch)."""
    from .rates import _LN_PA_RU
    dev, N, B = y_t.device, dims[0], y_t.shape[-1]
    _check('y_t', y_t, (N, B), F64, dev)
    _check('P_t', P_t, (1, B), F64, dev)
    ptrs = table_ptrs(tabs, F64, dev, 'stage A')
    lib = load()
    if lib.pyjac_stage_a_n_tables() != len(tabs):
        raise RuntimeError('stage-A table count mismatch: %d in Python, %d '
                           'in the kernel' % (len(tabs),
                                              lib.pyjac_stage_a_n_tables()))
    cdims = (ctypes.c_int * 12)(*dims[:12])
    if plan is None:
        with span('pyjac.kernels.plan'):
            plan = plan_ints(_plan(dims, 'stage_a', F64, B, _n_sm(dev)))
    cplan = _plan_arg(plan, lib.pyjac_stage_a_tile_rows(cdims), 'stage A')
    with span('pyjac.kernels.alloc'):
        out = {k: torch.empty((rows, B), dtype=F64, device=dev)
               for k, rows in (('src', dims[12]), ('col0', N), ('f', N),
                               ('post', dims[13]))}
        scratch = torch.empty((max(1, plan[4]),), dtype=F64, device=dev)
    args = [ptrs, len(tabs), cdims, 12, _LN_PA_RU, _ptr(y_t), _ptr(P_t),
            B, *(_ptr(out[k]) for k in ('src', 'col0', 'f', 'post')),
            _ptr(scratch), cplan, 4, _stream(dev)]
    return lib, args, out, scratch


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
    from .rates import _LN_PA_RU
    from .jacobian_big import PARTS_INT_TABLES
    dev, N, R, B = st_rows.device, mod.N, mod.R, st_rows.shape[-1]
    with span('pyjac.kernels.prepare'):
        _check('st_rows', st_rows, (5 + 3 * N, B), F64, dev)
        _check('roles', roles, (mod.n_roles, R, B), F64, dev)
        if not (0 <= row0 and 0 < rows and row0 + rows <= R):
            raise ValueError('reaction rows [%d, %d) outside [0, %d)'
                             % (row0, row0 + rows, R))
        # the checked table pointers, kept on the module under the
        # buffers' addresses (a 654-class pass is host-bound), so a moved
        # or reassigned buffer is checked and passed anew
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
    _launch(lib.pyjac_big_parts,
            (ptrs, n_tabs, cdims, n_dims, _LN_PA_RU, _ptr(st_rows), B, row0,
             rows, int(bool(has_pm)), _ptr(roles), _stream(dev)),
            dev, 'big_parts', 'K5 reaction-parts kernel')
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
    with span('pyjac.kernels.prepare'):
        _check('p1', p1, (J * mod.Rmax, B), F64, dev)
        _check('post', post, (mod.n_post, B), F64, dev)
        ptr, src, coef = (getattr(mod, prefix + k)
                          for k in ('ptr', 'src', 'coef'))
        owner = type(mod).__name__ + '.'
        for tname, t, want, shape in ((prefix + 'ptr', ptr, torch.int32,
                                       (J * N + 1,)),
                                      (prefix + 'src', src, torch.int32,
                                       src.shape),
                                      (prefix + 'coef', coef, F64, src.shape),
                                      ('inv_mw', mod.inv_mw, F64, (N,))):
            _check(owner + tname, t, shape, want, dev)
        lib = load()
        with span('pyjac.kernels.alloc'):
            out = torch.empty((J, N, B), dtype=F64, device=dev)
    _launch(lib.pyjac_big_cols_sparse,
            (_ptr(ptr), _ptr(src), _ptr(coef), _ptr(mod.inv_mw), _ptr(p1),
             _ptr(post), _ptr(out), N, mod.Rmax, int(mod.conp), B,
             _stream(dev)), dev, name, what)
    return out


def big_cols_dense(mod, roles, post):
    """Launch the K7 kernel (``csrc/big_cols_dense.cu``): the (J, N, B)
    columns of ``mod`` (a ``BigJacobian`` with ``sparse_cols=False``)
    from the role array and the post rows, through the per-column active
    reactions and their CSR (``jacobian_big.dense_active_tables``)."""
    dev, N, R, J, B = roles.device, mod.N, mod.R, mod.J, roles.shape[-1]
    with span('pyjac.kernels.prepare'):
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
        with span('pyjac.kernels.alloc'):
            out = torch.empty((J, N, B), dtype=F64, device=dev)
    _launch(lib.pyjac_big_cols_dense,
            (*(_ptr(t[k]) for k in ('act', 'ptr', 'src', 'coef', 'spf', 'spp',
                                    'eff', 'pd')),
             _ptr(mod.inv_mw), _ptr(roles), _ptr(post), _ptr(out), N, R,
             mod.Sf, mod.Sp, A, int(mod.conp), B, _stream(dev)),
            dev, 'big_cols_dense', 'K7 dense column kernel')
    return out


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
    return _launch_dense(*dense_inputs(mod, torch.float32), y_t, P_t,
                         torch.float32, plan_ints(plan))


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
    from .jacobian_sparse import SparseJacobian
    if kernel is None:
        kernel = ('stage_a' if isinstance(mod, SparseJacobian) else
                  'dense_fused')
    return _plan(_kinetics_dims(mod), kernel, dtype, B, n_sm, tile,
                 placement)


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


def _plan_arg(plan, kernel_rows: int, what: str):
    """``plan`` (:func:`plan_ints`) as the C entries take it, after
    checking its rows against the kernel's own count."""
    if kernel_rows != plan[3]:
        raise RuntimeError('%s: tile rows mismatch: %d in Python, %d in the '
                           'kernel' % (what, plan[3], kernel_rows))
    return (ctypes.c_longlong * 4)(*plan[:4])


# K4's kernel in each type: (C entry, launch counter, what it is)
_DENSE_ENTRIES = {F64: ('pyjac_dense_fused', 'dense_fused',
                        'K4 dense fused kernel'),
                  torch.float32: ('pyjac_fused_f32', 'fused_f32',
                                  'K3 f32 fused kernel')}


def _launch_dense(tabs, dims, y_t, P_t, dtype, plan=None):
    """K4's kernel in ``dtype`` (K4, or K3 in float32) on the tables and
    dims of :func:`dense_inputs`, counted: (Jt, f)."""
    entry, name, what = _DENSE_ENTRIES[dtype]
    with span('pyjac.kernels.prepare'):
        lib, args, Jt, f, _scratch = dense_args(tabs, dims, y_t, P_t, dtype,
                                                plan)
    _launch(getattr(lib, entry), args, y_t.device, name, what)
    return Jt, f


def _dense_prologue(tabs, dims, y_t, P_t, dtype, kernel, what, plan,
                    contiguous=True):
    """The checks and plan a launch on K4's tables takes (K4 / K3,
    ``kernel`` 'dense_fused', or the dy/dt kernel, 'dydt', whose states
    may have any strides: not ``contiguous``): (the library, the table
    pointers, the C dims, the plan (:func:`plan_ints`; default the
    planner's for the card) and the plan as the C entry takes it)."""
    dev, N, B = y_t.device, dims[0], y_t.shape[-1]
    _check('y_t', y_t, (N, B), dtype, dev, contiguous)
    _check('P_t', P_t, (1, B), dtype, dev)
    ptrs = table_ptrs(tabs, dtype, dev, what)
    lib = load()
    if lib.pyjac_dense_fused_n_tables() != len(tabs):
        raise RuntimeError('%s: table count mismatch: %d in Python, %d in '
                           'the kernel' % (what, len(tabs),
                                           lib.pyjac_dense_fused_n_tables()))
    cdims = (ctypes.c_int * len(dims))(*dims)
    if plan is None:
        with span('pyjac.kernels.plan'):
            plan = plan_ints(_plan(dims, kernel, dtype, B, _n_sm(dev)))
    rows = (lib.pyjac_dydt_tile_rows if kernel == 'dydt' else
            lib.pyjac_dense_fused_tile_rows)(cdims)
    return lib, ptrs, cdims, plan, _plan_arg(plan, rows, what)


def dense_args(tabs, dims, y_t, P_t, dtype, plan=None):
    """Everything a launch of K4's kernel in ``dtype`` passes, checked,
    for the tables and dims of :func:`dense_inputs` under ``plan``
    (:func:`plan_ints`; default :func:`tile_plan`'s for the card): (the
    library, the argument list, the outputs Jt and f it fills, the
    scratch it uses: keep it until the launch)."""
    from .rates import _LN_PA_RU
    dev, N, B = y_t.device, dims[0], y_t.shape[-1]
    lib, ptrs, cdims, plan, cplan = _dense_prologue(
        tabs, dims, y_t, P_t, dtype, 'dense_fused', _DENSE_ENTRIES[dtype][2],
        plan)
    with span('pyjac.kernels.alloc'):
        Jt = torch.empty((N, N, B), dtype=dtype, device=dev)
        f = torch.empty((N, B), dtype=dtype, device=dev)
        scratch = torch.empty((max(1, plan[4]),), dtype=dtype, device=dev)
    args = [ptrs, len(tabs), cdims, len(dims), _LN_PA_RU, _ptr(y_t),
            _ptr(P_t), B, _ptr(Jt), _ptr(f), _ptr(scratch), cplan, 4,
            _stream(dev)]
    return lib, args, Jt, f, scratch


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


# ---------------------------------------------------------------------------
# K1, K2 and K4 as PyTorch operators (what torch.export traces and an
# exported program calls); one implementation each, for CUDA.  Defined
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


def _stage_a_op(tables, dims, y_t, P_t, plan=None):
    """K1, counted: (src, col0, f, post) from :func:`stage_a_inputs`."""
    with span('pyjac.kernels.prepare'):
        lib, args, out, _scratch = stage_a_args(tables, dims, y_t, P_t,
                                                plan)
    _launch(lib.pyjac_stage_a, args, y_t.device, 'stage_a', 'stage A kernel')
    return out['src'], out['col0'], out['f'], out['post']


def _stage_b_op(tables, dims, src, post):
    """K2, counted: the (J, N, B) columns from :func:`stage_b_inputs`."""
    (N, conp, n_src, n_post), B = dims, src.shape[-1]
    dev = src.device
    with span('pyjac.kernels.prepare'):
        _check('src', src, (n_src, B), F64, dev)
        _check('post', post, (n_post, B), F64, dev)
        ptrs = table_ptrs(tables, F64, dev, 'stage B')
        lib = load()
        with span('pyjac.kernels.alloc'):
            out = torch.empty((N - 1, N, B), dtype=F64, device=dev)
    _launch(lib.pyjac_stage_b, (*ptrs, _ptr(src), _ptr(post), _ptr(out), N,
                                conp, B, _stream(dev)),
            dev, 'stage_b', 'stage B kernel')
    return out


def _dense_fused_op(tables, dims, y_t, P_t, plan=None):
    """K4, counted: (Jt, f) from :func:`dense_inputs`."""
    return _launch_dense(tables, dims, y_t, P_t, F64, plan)


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


def _dydt_op(tables, dims, y_t, P_t, plan=None):
    """The dy/dt kernel, counted: f (N, B) from :func:`dense_inputs`'
    tables and dims, laid out as ``y_t``."""
    from .rates import _LN_PA_RU
    dev, B = y_t.device, y_t.shape[-1]
    with span('pyjac.kernels.prepare'):
        lib, ptrs, cdims, plan, cplan = _dense_prologue(
            tables, dims, y_t, P_t, F64, 'dydt', 'dy/dt kernel', plan,
            contiguous=False)
        with span('pyjac.kernels.alloc'):
            f = torch.empty_like(y_t)
            scratch = torch.empty((max(1, plan[4]),), dtype=F64, device=dev)
    _launch(lib.pyjac_dydt,
            (ptrs, len(tables), cdims, len(dims), _LN_PA_RU, _ptr(y_t),
             *y_t.stride(), _ptr(P_t), B, _ptr(f), *f.stride(),
             _ptr(scratch), cplan, 4, _stream(dev)),
            dev, 'dydt', 'dy/dt kernel')
    return f


_OPS.impl('stage_a', _stage_a_op, 'CUDA')
_OPS.impl('stage_b', _stage_b_op, 'CUDA')
_OPS.impl('dense_fused', _dense_fused_op, 'CUDA')
_OPS.impl('lu_factor', _lu_factor_op, 'CUDA')
_OPS.impl('lu_solve', _lu_solve_op, 'CUDA')
_OPS.impl('dydt', _dydt_op, 'CUDA')


@torch.library.register_fake('pyjac_tpu_torch::stage_a', lib=_OPS)
def _(tables, dims, y_t, P_t, plan=None):
    B = y_t.shape[-1]
    return tuple(y_t.new_empty((rows, B))
                 for rows in (dims[12], dims[0], dims[0], dims[13]))


@torch.library.register_fake('pyjac_tpu_torch::stage_b', lib=_OPS)
def _(tables, dims, src, post):
    return src.new_empty((dims[0] - 1, dims[0], src.shape[-1]))


@torch.library.register_fake('pyjac_tpu_torch::dense_fused', lib=_OPS)
def _(tables, dims, y_t, P_t, plan=None):
    N, B = dims[0], y_t.shape[-1]
    return y_t.new_empty((N, N, B)), y_t.new_empty((N, B))


@torch.library.register_fake('pyjac_tpu_torch::lu_factor', lib=_OPS)
def _(J, s):
    B, N = J.shape[0], J.shape[-1]
    return (J.new_empty((B, N, N)), J.new_empty((B, N), dtype=torch.int32),
            J.new_empty((B,), dtype=torch.bool))


@torch.library.register_fake('pyjac_tpu_torch::lu_solve', lib=_OPS)
def _(LU, piv, rhs):
    return rhs.new_empty(rhs.shape)


@torch.library.register_fake('pyjac_tpu_torch::dydt', lib=_OPS)
def _(tables, dims, y_t, P_t, plan=None):
    return torch.empty_like(y_t)
