"""The port's ``libgen`` (``torch.export``) against the JAX package's
(``jax.export``), on the CPU.

The plain float64 artifacts (``dydt``, ``jacobian``, ``jacobian_and_dydt``,
``rates``; CONP and CONV) exported and loaded by the port must agree with
the JAX package's loaded artifacts on the same numpy states at
``tests/test_libgen.py``'s 1e-12 of scale, at two batch sizes from one
artifact.  The kernel entries' operators (K1, K2, K4) have one
implementation, for CUDA; here their fake implementations are checked by
an export on the ``meta`` device and by ``torch.library.opcheck``.  An
export with cold table caches must leave later eager calls real, and a
library loads in a process that never builds the mechanism.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.libgen import generate_library as jgenerate_library
from pyjac_tpu.libgen import load_library as jload_library
from pyjac_tpu.ops.thermo import eval_conc as jeval_conc
from pyjac_tpu_torch import libgen
from pyjac_tpu_torch.ops import common, kernels
from pyjac_tpu_torch.ops.dydt import dydt
from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt
from pyjac_tpu_torch.ops.jacobian_big import BigJacobian
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian
from pyjac_tpu_torch.testers.synthetic import (packed_from_text,
                                               plausible_mechanism,
                                               random_states)

torch.set_num_threads(1)

REPO = __import__('pathlib').Path(__file__).resolve().parent.parent
TEXT = plausible_mechanism(12, 30, seed=3)
PLAIN = ('dydt', 'jacobian', 'jacobian_and_dydt', 'rates')
# JAX's f32 artifacts against the f64 computation on the same float32
# inputs, of scale: its float32 steps before its float64 tables (measured
# up to 1.5e-7 on this mechanism's states)
F32_STEPS = 1e-6


@pytest.fixture(scope='module')
def mech(tmp_path_factory):
    """(port packed, JAX packed, 17 random states, their pressures and
    densities) of a dozen-species plausible mechanism."""
    path = tmp_path_factory.mktemp('mech') / 'm.inp'
    path.write_text(TEXT)
    jm = JMechanism.from_files(str(path))
    jp = jpack(jm)
    y, T, P = random_states(jm, 17, seed=3)
    y = np.ascontiguousarray(y)
    rho = np.asarray(jeval_conc(jp, T, P, y[:, 1:])[2])
    return packed_from_text(TEXT)[1], jp, y, P, rho


@pytest.fixture(scope='module')
def libs(mech, tmp_path_factory):
    """{conp: (the port's loaded library, JAX's)} of the plain kernels,
    built once each."""
    p, jp, *_ = mech
    out = {}
    for conp in (True, False):
        d = tmp_path_factory.mktemp('lib')
        libgen.generate_library(p, str(d / 'torch'), PLAIN, conp=conp,
                                device='cpu')
        jgenerate_library(jp, str(d / 'jax'), PLAIN, conp=conp)
        out[conp] = (libgen.load_library(str(d / 'torch')),
                     jload_library(str(d / 'jax')))
    return out


def _close(a, b):
    scale = float(np.abs(b).max()) + 1e-300
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('kernel', PLAIN)
def test_plain_artifacts_match_jax(libs, mech, kernel, conp):
    """One artifact at B = 5 and B = 17 (param: pressure under CONP,
    density under CONV) against JAX's loaded artifact, scaled 1e-12."""
    lib, jlib = libs[conp]
    _, _, y, P, rho = mech
    man = lib['manifest']
    assert man['format'] == 'torch.export/pt2' and man['device'] == 'cpu'
    assert man['conp'] is conp and man['n_species'] == 12
    assert man['param'].startswith('pressure' if conp else 'density')
    jman = jlib['manifest']
    for key in ('n_species', 'n_reactions', 'species', 'conp', 'dtype',
                'state_layout', 'param'):
        assert man[key] == jman[key], key
    param = P if conp else rho
    for B in (5, 17):
        got = lib[kernel](torch.tensor(param[:B]), torch.tensor(y[:B]))
        want = jlib[kernel](param[:B], y[:B])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape[0] == B
            _close(a.numpy(), np.asarray(b))


def _tensors(v):
    """The tensors a cache entry holds."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, torch.nn.Module):
        return list(v.buffers())
    items = (vars(v).values() if hasattr(v, '__dict__') else
             v.values() if isinstance(v, dict) else
             v if isinstance(v, (tuple, list)) else ())
    return [t for x in items for t in _tensors(x)]


def test_cold_cache_export_then_eager():
    """Exports with the table caches cold (a mechanism packed anew, no
    warm-up), then eager calls: each returns a real tensor equal to the
    call on a mechanism the export never saw and to the exported
    program's, a second kernel exports after the first, and the cache
    holds no fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    mech, p = packed_from_text(TEXT)
    y, _, P = random_states(mech, 9, seed=5)
    y, P = torch.as_tensor(np.ascontiguousarray(y)), torch.as_tensor(P)
    progs = {name: libgen.export_kernel(p, name, True, 'cpu').module()
             for name in ('dydt', 'jacobian_and_dydt')}
    f = dydt(p, 0.0, P, y)
    J, _ = jacobian_and_dydt(p, 0.0, P, y)
    assert type(f) is torch.Tensor and type(J) is torch.Tensor
    fresh = packed_from_text(TEXT)[1]
    assert torch.equal(f, dydt(fresh, 0.0, P, y))
    assert torch.equal(J, jacobian_and_dydt(fresh, 0.0, P, y)[0])
    assert torch.equal(progs['dydt'](P, y), f)
    assert torch.equal(progs['jacobian_and_dydt'](P, y)[0], J)
    cached = [t for _, v in common._CACHE.values() for t in _tensors(v)]
    assert cached and not any(isinstance(t, FakeTensor) for t in cached)


@pytest.mark.parametrize('name,ops', [
    ('jacobian_dd_sparse', ['pyjac_tpu_torch.stage_a.default',
                            'pyjac_tpu_torch.stage_b.default']),
    ('jacobian_dd', ['pyjac_tpu_torch.dense_fused.default'])])
def test_kernel_entries_export_through_the_operators(mech, name, ops):
    """On the ``meta`` device (shapes only) a kernel entry's program calls
    the registered operators, and every output keeps the batch
    symbolic: (J_cols (J, N, b), col0, f) or (Jt (N, N, b), f)."""
    p = mech[0]
    N = p.n_species
    prog = libgen.export_kernel(p, name, True, 'meta')
    called = [str(n.target) for n in prog.graph.nodes
              if n.op == 'call_function' and 'pyjac' in str(n.target)]
    assert called == ops
    out = [n for n in prog.graph.nodes if n.op == 'output'][0].args[0]
    shapes = [o.meta['val'].shape for o in out]
    want = ([(N - 1, N), (N,), (N,)] if name == 'jacobian_dd_sparse' else
            [(N, N), (N,)])
    assert [tuple(s[:-1]) for s in shapes] == want
    assert all(isinstance(s[-1], torch.SymInt) for s in shapes)


def test_operators_fake_implementations_opcheck(mech):
    """``torch.library.opcheck`` of the three operators on meta tensors
    (schema, fake implementation, dynamic shapes); on CPU tensors they
    have no implementation, and the launchers refuse them."""
    p = mech[0]
    N, B = p.n_species, 7
    meta = dict(dtype=torch.float64, device='meta')
    sj = SparseJacobian(p, device='meta')
    dj = DenseJacobian(p, device='meta')
    y_t, P_t = torch.empty((N, B), **meta), torch.empty((1, B), **meta)
    src = torch.empty((sj.n_src, B), **meta)
    post = torch.empty((sj.n_post, B), **meta)
    ops = torch.ops.pyjac_tpu_torch
    plan = kernels.plan_ints(kernels.tile_plan(sj, torch.float64, B))
    for args in ((y_t, P_t), (y_t, P_t, plan)):
        torch.library.opcheck(ops.stage_a.default,
                              (*kernels.stage_a_inputs(sj), *args))
    torch.library.opcheck(ops.stage_b.default,
                          (*kernels.stage_b_inputs(sj), src, post))
    torch.library.opcheck(ops.dense_fused.default,
                          (*kernels.dense_inputs(dj, torch.float64), y_t,
                           P_t))
    cpu = DenseJacobian(p, device='cpu')
    with pytest.raises(NotImplementedError):
        ops.dense_fused(*kernels.dense_inputs(cpu, torch.float64),
                        torch.zeros((N, B), dtype=torch.float64),
                        torch.ones((1, B), dtype=torch.float64))


def _kinetics_dims(m):
    """The kinetics dims as the C entries read them: N, R, the slots a
    side, PLOG pressures, Chebyshev T and P orders, conp, has_frac,
    has_pm, has_spec."""
    p = m.packed
    return [m.N, m.R, p.reac_sp.shape[1], p.prod_sp.shape[1],
            p.plog_lnP.shape[1], *p.cheb_coef.shape[1:], int(m.conp),
            int(p.has_frac_nu), int(p.has_pres_mod),
            int(p.has_specific_pdep_sp)]


# each kernel that reads a module's tables: (its module, its gatherer, the
# dims its launch passes); the dy/dt kernel takes K4's
GATHERERS = {
    'K1': (lambda p: SparseJacobian(p, device='cpu'), kernels.stage_a_inputs,
           lambda m: _kinetics_dims(m) + [m.S_eff, m.n_src, m.n_post]),
    'K2': (lambda p: SparseJacobian(p, device='cpu'), kernels.stage_b_inputs,
           lambda m: [m.N, 1, m.n_src, m.n_post]),
    'K2x': (lambda p: SparseJacobian(p, fuse_gather=False, device='cpu'),
            lambda m: kernels.cols_sparse_inputs(m, 'kx_'),
            lambda m: [m.N, m.Rmax, 1]),
    'K3': (lambda p: F32Jacobian(p, device='cpu'),
           lambda m: kernels.dense_inputs(m, torch.float32), _kinetics_dims),
    'K4': (lambda p: DenseJacobian(p, device='cpu'),
           lambda m: kernels.dense_inputs(m, torch.float64), _kinetics_dims),
    'dydt': (lambda p: DenseJacobian(p, device='cpu'),
             lambda m: kernels.dense_inputs(m, torch.float64),
             _kinetics_dims),
    'K5': (lambda p: BigJacobian(p, device='cpu'), kernels.parts_inputs,
           lambda m: [m.N, m.R, m.Sf, m.Sp, m.packed.plog_lnP.shape[1],
                      *m.packed.cheb_coef.shape[1:], 1,
                      int(m.packed.has_frac_nu)]),
    'K6': (lambda p: BigJacobian(p, device='cpu'),
           lambda m: kernels.cols_sparse_inputs(m, 'ks_'),
           lambda m: [m.N, m.Rmax, 1]),
    'K7': (lambda p: BigJacobian(p, sparse_cols=False, device='cpu'),
           kernels.cols_dense_inputs,
           lambda m: [m.N, m.R, m.Sf, m.Sp, m.kd_act.shape[1], 1]),
}


@pytest.mark.parametrize('kernel', list(GATHERERS))
def test_kernel_inputs_are_kept_while_the_buffers_are(mech, kernel):
    """A kernel's tables and dims, which every launch passes, are
    gathered once and kept while its module's buffers are the same
    tensors: a reassigned table or a move gathers anew, and under a
    tracer (a fake tensor mode) they are gathered afresh, not kept.  A
    table of the wrong dtype, or of the wrong shape where the kernel
    reads 1/W, is refused when gathered."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    make, gather, dims = GATHERERS[kernel]
    mod = make(mech[0])
    kept = gather(mod)
    assert gather(mod) is kept and kept[1] == dims(mod)
    assert all(any(t is b for b in mod._buffers.values()) for t in kept[0])
    with FakeTensorMode():
        assert gather(mod) is not kept
    assert gather(mod) is kept
    name = next(k for k, b in mod._buffers.items()
                if any(t is b for t in kept[0]))
    table = mod._buffers[name]
    setattr(mod, name, table.clone())
    tabs = gather(mod)[0]
    assert tabs is not kept[0] and any(t is mod._buffers[name] for t in tabs)
    setattr(mod, name, table.to(torch.float16))
    with pytest.raises(ValueError, match=name):
        gather(mod)
    setattr(mod, name, table)
    if any(t is mod.inv_mw for t in tabs):
        setattr(mod, 'inv_mw', torch.cat([mod.inv_mw, mod.inv_mw[:1]]))
        with pytest.raises(ValueError, match='inv_mw'):
            gather(mod)
        setattr(mod, 'inv_mw', mod.inv_mw[:-1].clone())
    before = gather(mod)
    mod.to('meta')
    after = gather(mod)
    assert after is not before and after[1] == before[1]
    assert all(t.device.type == 'meta' for t in after[0])


def test_load_library_in_a_fresh_process(mech, tmp_path):
    """A library loads and runs in a process that never parses or packs
    a mechanism (those functions raise there) and imports no JAX: its
    dydt and sparse kernel entry equal the live calls."""
    p, _, y, P, _ = mech
    d = tmp_path / 'lib'
    libgen.generate_library(p, str(d), ('dydt', 'jacobian_dd_sparse'),
                            device='cpu')
    np.save(tmp_path / 'y.npy', y)
    np.save(tmp_path / 'P.npy', P)
    code = '''
import sys, numpy as np, torch
import pyjac_tpu_torch.core.pack as pk, pyjac_tpu_torch.core.mech as mm
def refuse(*a, **k):
    raise AssertionError('the mechanism was built')
pk.pack = pk.packed_from_arrays = refuse
mm.Mechanism.from_files = refuse
from pyjac_tpu_torch.libgen import load_library
lib = load_library(sys.argv[1])
y = torch.as_tensor(np.load(sys.argv[2]))
P = torch.as_tensor(np.load(sys.argv[3]))
np.save(sys.argv[4], lib['dydt'](P, y).numpy())
cols, col0, f = lib['jacobian_dd_sparse'](y.T.contiguous(),
                                          P[None].contiguous())
np.savez(sys.argv[5], cols=cols.numpy(), col0=col0.numpy(), f=f.numpy())
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pyjac_tpu')]
assert not bad, bad
'''
    out = subprocess.run(
        [sys.executable, '-c', code, str(d), str(tmp_path / 'y.npy'),
         str(tmp_path / 'P.npy'), str(tmp_path / 'f.npy'),
         str(tmp_path / 'sj.npz')], cwd=str(REPO), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    yt, Pt = torch.as_tensor(y), torch.as_tensor(P)
    assert np.array_equal(np.load(tmp_path / 'f.npy'),
                          dydt(p, 0.0, Pt, yt).numpy())
    got = np.load(tmp_path / 'sj.npz')
    cols, col0, f = SparseJacobian(p, device='cpu').call_tr(
        yt.T.contiguous(), Pt[None].contiguous())
    for k, v in (('cols', cols), ('col0', col0), ('f', f)):
        assert np.array_equal(got[k], v.numpy()), k
    man = json.loads((d / 'library.json').read_text())
    assert set(man['kernels']) == {'dydt', 'jacobian_dd_sparse'}
    assert 'J_cols' in man['dd_sparse_layout']


def test_generate_library_refuses_what_it_cannot_export(mech, tmp_path):
    """The default device is the card, absent here; an unknown kernel
    raises."""
    with pytest.raises(RuntimeError, match='CUDA'):
        libgen.generate_library(mech[0], str(tmp_path), ('dydt',))
    with pytest.raises(ValueError):
        libgen.export_kernel(mech[0], 'nope', True, 'cpu')


@pytest.fixture(scope='module')
def libs_f32(mech, tmp_path_factory):
    """{conp: (the port's loaded f32 library, JAX's)} of the plain
    kernels, exported with ``dtype='f32'``."""
    p, jp, *_ = mech
    out = {}
    for conp in (True, False):
        d = tmp_path_factory.mktemp('lib32')
        libgen.generate_library(p, str(d / 'torch'), PLAIN, conp=conp,
                                device='cpu', dtype='f32')
        jgenerate_library(jp, str(d / 'jax'), PLAIN, conp=conp, dtype='f32')
        out[conp] = (libgen.load_library(str(d / 'torch')),
                     jload_library(str(d / 'jax')))
    return out


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('kernel', PLAIN)
def test_f32_artifacts_match_jax(libs, libs_f32, mech, kernel, conp):
    """``dtype='f32'``: each plain artifact takes float32 ``(param, y)``
    and returns float64, as JAX's f32 artifact does; at B = 5 and 17 it
    equals the live f64 function on those inputs cast up (bit for bit)
    and agrees with JAX's f64 artifact there at 1e-12 of scale (float64
    roundoff).  JAX's f32 artifact runs the operations on its inputs
    alone (T, ln T, 1/T, the mass-fraction sums) in float32 before they
    meet its float64 tables, so it reads within F32_STEPS of scale."""
    lib, jlib = libs_f32[conp]
    jlib64 = libs[conp][1]
    _, _, y, P, rho = mech
    assert lib['manifest']['dtype'] == jlib['manifest']['dtype'] == 'f32'
    param = np.asarray(P if conp else rho, np.float32)
    y32 = np.asarray(y, np.float32)
    live = libgen._kernel_fn(mech[0], kernel, conp)
    tup = lambda x: tuple(x) if isinstance(x, (tuple, list)) else (x,)
    for B in (5, 17):
        p32, yb = param[:B], y32[:B]
        got = tup(lib[kernel](torch.tensor(p32), torch.tensor(yb)))
        ref = tup(live(torch.tensor(p32).double(), torch.tensor(yb).double()))
        j64 = tup(jlib64[kernel](p32.astype(np.float64),
                                 yb.astype(np.float64)))
        j32 = tup(jlib[kernel](p32, yb))
        assert len(got) == len(ref) == len(j64) == len(j32)
        for a, r, b64, b32 in zip(got, ref, j64, j32):
            b64, b32 = np.asarray(b64), np.asarray(b32)
            assert a.dtype == torch.float64 and b32.dtype == np.float64
            assert a.shape == b32.shape and a.shape[0] == B
            assert torch.equal(a, r)
            _close(a.numpy(), b64)
            scale = float(np.abs(b32).max()) + 1e-300
            assert float(np.abs(a.numpy() - b32).max()) <= F32_STEPS * scale


def test_f32_library_keeps_the_entries_interface(mech, tmp_path):
    """The kernel entries' interface does not change with ``dtype``, as
    in the JAX package: an f32 library's ``jacobian_dd_sparse`` and
    ``jacobian_dd`` take float64 batch-minor states, equal to the f64
    library's; an unknown dtype raises."""
    p, _, y, P, _ = mech
    outs = {}
    for dtype in ('f32', 'f64'):
        d = tmp_path / dtype
        libgen.generate_library(p, str(d), ('jacobian_dd_sparse',
                                            'jacobian_dd'), device='cpu',
                                dtype=dtype)
        lib = libgen.load_library(str(d))
        assert lib['manifest']['dtype'] == dtype
        y_t = torch.as_tensor(y[:5].T.copy())
        P_t = torch.as_tensor(P[None, :5].copy())
        outs[dtype] = [lib[k](y_t, P_t)
                       for k in ('jacobian_dd_sparse', 'jacobian_dd')]
    for a, b in zip(outs['f32'], outs['f64']):
        assert all(torch.equal(x, z) and x.dtype == torch.float64
                   for x, z in zip(a, b))
    with pytest.raises(ValueError, match='dtype'):
        libgen.generate_library(p, str(tmp_path / 'x'), ('dydt',),
                                device='cpu', dtype='bf16')
