"""The port's large-mechanism pipeline (``BigJacobian``) against the JAX
package, on the CPU.

On CPU tensors ``BigJacobian`` runs the plain versions of its three CUDA
kernels (``parts_reference``, ``cols_sparse_reference``,
``cols_dense_reference``).  These tests hold its column tables against
the JAX package's ``_sparse_col_pack_expanded`` tables, its pre-stage +
parts + finish against the JAX dd sections (run eagerly under
``barrier_mode('xla')``, never jitted on the CPU, and never through
``PallasDDJacobianBig(interpret=True)``, which takes minutes), the whole
slice against the JAX f64 ``jacobian_and_dydt``, and both reference-C
goldens.  The mechanisms are parsed by the JAX package and carried over
with ``packed_from_arrays``, so both sides compute from the same
numbers.  The kernels run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops.jacobian import jacobian_and_dydt as jjacobian_and_dydt
from pyjac_tpu.testers.synthetic import (plausible_mechanism,
                                         random_states,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import packed_from_arrays
from pyjac_tpu_torch.ops.jacobian_big import (BigJacobian,
                                              cols_dense_reference,
                                              dense_active_tables,
                                              dense_col_tables,
                                              expanded_col_tables, finish,
                                              p1_dense, parts_reference,
                                              state_thermo)
from pyjac_tpu_torch.ops.jacobian_sparse import (SparseJacobian, post_rows,
                                                 post_col_reference)
from pyjac_tpu_torch.testers.synthetic import packed_from_text
from pyjac_tpu_torch.testers.synthetic import (
    plausible_mechanism as port_plausible_mechanism)

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'

MECHS = {
    'synth': lambda: synthetic_mechanism(n_species=9, n_reactions=24,
                                         seed=7),
    'gri': lambda: synthetic_mechanism(n_species=9, n_reactions=24, seed=7,
                                       gri_mix=True),
    'small': lambda: synthetic_mechanism(n_species=6, n_reactions=10,
                                         seed=7, gri_mix=True),
    'n_eq_r': lambda: synthetic_mechanism(n_species=9, n_reactions=9,
                                          seed=3),
    'flagship': lambda: plausible_mechanism(53, 325, seed=42),
    'usc': lambda: plausible_mechanism(111, 784, seed=5),
}
_CACHE = {}


def _mech(tmp_path_factory, name):
    """(JAX mech, JAX packed, port packed from the JAX arrays)."""
    if name not in _CACHE:
        path = tmp_path_factory.mktemp(name) / 'm.inp'
        path.write_text(MECHS[name]())
        jm = JMechanism.from_files(str(path))
        jp = jpack(jm)
        fields = {k: getattr(jp, k) for k in jp.__dataclass_fields__
                  if k != 'mech'}
        p = packed_from_arrays(fields, Mechanism.from_files(str(path)))
        _CACHE[name] = (jm, jp, p)
    return _CACHE[name]


def _floored(a, b, floor):
    a = np.asarray(a).reshape(len(b), -1)
    b = np.asarray(b).reshape(len(b), -1)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


def _norm_rel(a, b):
    a = np.asarray(a).reshape(len(b), -1)
    b = np.asarray(b).reshape(len(b), -1)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


def _row_rel(a, b):
    """Per-row norm-relative error of (rows, B) arrays."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(np.abs(b).max(-1), 1e-300)
    return float((np.abs(a - b).max(-1) / scale).max())


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['synth', 'gri', 'small', 'n_eq_r',
                                  'flagship'])
def test_tables_match_jax(tmp_path_factory, name):
    """``gidx``, ``Rmax`` and the source-stack size equal the JAX
    package's ``_sparse_col_pack_expanded`` with one-column blocks and
    one Rmax class; ``nuc`` is the JAX ``nuc * nu_rs`` wherever the JAX
    table has no deep (fractional-nu) column."""
    from pyjac_tpu.ops.pallas_dd import _consts_dd, _sparse_col_pack_expanded
    _, jp, p = _mech(tmp_path_factory, name)
    _, meta = _consts_dd(jp, compact_pdep=True)
    SCx = _sparse_col_pack_expanded(jp, meta, jb=1, n_classes=1)
    ex = expanded_col_tables(p)
    assert SCx['J_pad'] == p.n_species - 1
    for k in ('Rmax', 'n_src'):
        assert ex[k] == SCx[k], k
    assert np.array_equal(ex['gidx'], SCx['gidx'])
    ok = np.setdiff1d(np.arange(SCx['J_pad']), SCx['deep_cols'])
    nuc_j = SCx['nuc'].astype(np.float64) * SCx['nu_rs'].astype(np.float64)
    assert np.array_equal(ex['nuc'][ok], nuc_j[ok])


def _k7_mech(tmp_path_factory, name):
    """The port's packed mechanism for the K7 table tests: the 654-species
    class (packed by the port alone), or one of :data:`MECHS`."""
    if name == '654':
        if name not in _CACHE:
            _CACHE[name] = packed_from_text(
                port_plausible_mechanism(654, 2716, seed=5))[1]
        return _CACHE[name]
    return _mech(tmp_path_factory, name)[2]


def _part_mask(td, J):
    """(R, J): reaction r's dense operand in column j is not zero by the
    tables alone (a slot, an efficiency or the pdep index names j)."""
    cols = np.arange(J)
    return ((td['spf'][:, :, None] == cols).any(1) |
            (td['spp'][:, :, None] == cols).any(1) |
            (td['eff'][:, :J] != 0) | (td['pd'][:, None] == cols))


@pytest.mark.parametrize('name', ['654', 'flagship', 'synth'])
def test_k7_active_tables(tmp_path_factory, name):
    """K7's per-column tables list exactly the reactions of the ``part``
    mask, ascending, with -1 only in the padding past them (A a multiple
    of 8); the CSR holds exactly the nonzero nu_net of those reactions,
    row by row, entries in ascending reaction order; and the dense
    operand is zero on every reaction outside the list."""
    p = _k7_mech(tmp_path_factory, name)
    td = dense_col_tables(p)
    at = dense_active_tables(td)
    N, J = p.n_species, p.n_species - 1
    part = _part_mask(td, J)
    act, ptr, src, coef = at['act'], at['ptr'], at['src'], at['coef']
    assert act.dtype == ptr.dtype == src.dtype == np.int32
    assert act.shape[0] == J and act.shape[1] % 8 == 0
    assert ptr.shape == (J * N + 1,) and ptr[0] == 0
    assert ptr[-1] == len(src) == len(coef)
    nnz = (td['nu_net'] != 0).sum(1)
    assert len(src) == int((part * nnz[:, None]).sum())
    for j in range(J):
        k = int(part[:, j].sum())
        assert np.array_equal(act[j, :k], np.nonzero(part[:, j])[0])
        assert (act[j, k:] == -1).all()
        for n in range(N):
            e = slice(ptr[j * N + n], ptr[j * N + n + 1])
            rs = act[j, src[e]]
            assert (np.diff(rs) > 0).all()
            assert np.array_equal(rs, act[j, :k][td['nu_net'][act[j, :k],
                                                              n] != 0])
            assert np.array_equal(coef[e], td['nu_net'][rs, n])
    rng = np.random.default_rng(11)
    Sf, Sp = td['spf'].shape[1], td['spp'].shape[1]
    roles = torch.as_tensor(rng.uniform(-1, 1, (Sf + Sp + 6, p.n_reactions,
                                                3)))
    t = {k: torch.as_tensor(v) for k, v in td.items()}
    for j in range(J):
        P1 = p1_dense(roles, Sf, Sp, t['spf'], t['spp'], t['eff'], t['pd'], j)
        assert not P1[torch.as_tensor(~part[:, j])].any()


def _csr_dcol(roles, t, J, N):
    """K7's contraction in plain torch from its CSR: column j's active
    operand rows, each entry's coefficient times its row, summed into its
    output row in entry order."""
    Sf, Sp = t['spf'].shape[1], t['spp'].shape[1]
    B = roles.shape[-1]
    ops = torch.stack([p1_dense(roles, Sf, Sp, t['spf'], t['spp'], t['eff'],
                                t['pd'], j)[t['act'][j].clamp_min(0)]
                       for j in range(J)], 0)                   # (J, A, B)
    ops = ops * (t['act'] >= 0)[..., None]
    counts = torch.diff(t['ptr'].long())
    cell = torch.repeat_interleave(torch.arange(J * N), counts)
    col = cell // N
    terms = t['coef'][:, None] * ops[col, t['src'].long()]
    dcol = torch.zeros((J * N, B), dtype=torch.float64)
    dcol.index_add_(0, cell, terms)
    mag = torch.zeros((J * N, B), dtype=torch.float64)
    mag.index_add_(0, cell, terms.abs())
    return dcol.view(J, N, B), mag.view(J, N, B)


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('name', ['654', 'flagship', 'synth'])
def test_k7_csr_contraction_matches_dense(tmp_path_factory, name, conp):
    """On seeded roles and post rows, the contraction over K7's CSR equals
    ``nu_net.T @ p1_dense(...)`` of every column to 1e-15 of the summed
    magnitude of its products, and finished by ``post_col_reference`` it
    gives ``cols_dense_reference``'s columns to 1e-13 of each column's
    largest entry (its temperature row sums the N rounded rows)."""
    p = _k7_mech(tmp_path_factory, name)
    bd = BigJacobian(p, conp=conp, sparse_cols=False, device='cpu')
    t = bd.tab('kd_')
    N, J, B = bd.N, bd.J, 3
    rng = np.random.default_rng(5)
    roles = torch.as_tensor(rng.uniform(-1, 1, (bd.n_roles, bd.R, B)))
    post = torch.as_tensor(rng.uniform(0.5, 2.0, (bd.n_post, B)))
    got, mag = _csr_dcol(roles, t, J, N)
    dense = torch.stack([t['nu_net'].T @ p1_dense(
        roles, bd.Sf, bd.Sp, t['spf'], t['spp'], t['eff'], t['pd'], j)
        for j in range(J)], 0)
    scale = mag.amax(1, keepdim=True).clamp_min(1e-300)
    assert float(((got - dense).abs() / scale).max()) < 1e-15
    cols = post_col_reference(got, torch.arange(J), bd.inv_mw, post, conp)
    ref = cols_dense_reference(roles, t, bd.inv_mw, post, conp)
    cscale = ref.abs().amax(1, keepdim=True).clamp_min(1e-300)
    assert float(((cols - ref).abs() / cscale).max()) < 1e-13


def test_k6_csr_stays_in_its_column_block(tmp_path_factory):
    """K6 stages column j's operand rows [j*Rmax, (j+1)*Rmax) alone, so
    each column's CSR entries must point inside that block."""
    for name in ('synth', 'flagship', 'usc'):
        bj = BigJacobian(_mech(tmp_path_factory, name)[2], device='cpu')
        col = torch.repeat_interleave(torch.arange(bj.J * bj.N),
                                      torch.diff(bj.ks_ptr.long())) // bj.N
        assert bool((bj.ks_src.long() // bj.Rmax == col).all()), name


def test_default_device_is_the_card(tmp_path_factory):
    """The default device is the card, so the default constructors raise
    on a host without one."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, _, p = _mech(tmp_path_factory, 'gri')
    for cls in (BigJacobian, SparseJacobian):
        with pytest.raises(RuntimeError, match='CUDA'):
            cls(p)


def test_big_launchers_refuse_cpu_tensors(tmp_path_factory):
    """No fallback: the K5/K6/K7 launchers given CPU tensors raise,
    build nothing and count no launch."""
    from pyjac_tpu_torch.ops import kernels
    _, _, p = _mech(tmp_path_factory, 'gri')
    bj = BigJacobian(p, device='cpu')
    bd = BigJacobian(p, device='cpu', sparse_cols=False)
    B, f64 = 4, torch.float64
    roles = torch.zeros((bj.n_roles, bj.R, B), dtype=f64)
    post = torch.zeros((bj.n_post, B), dtype=f64)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.big_parts(bj, torch.zeros((5 + 3 * bj.N, B), dtype=f64),
                          roles, 0, bj.R, True)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.big_cols_sparse(
            bj, torch.zeros((bj.J * bj.Rmax, B), dtype=f64), post)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.big_cols_dense(bd, roles, post)
    assert kernels.launches == before and kernels._lib is None


# ---------------------------------------------------------------------------
# pre-stage + K5's plain version + finish against the JAX dd sections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('conp', [True, False])
def test_parts_match_jax_dd_sections(tmp_path_factory, conp):
    from pyjac_tpu.ops import doublefloat as df
    from pyjac_tpu.ops.pallas_dd import (DDA, _compute_reaction_parts,
                                         _compute_state_thermo, _consts_dd,
                                         _finish_dd, _tiled_role_spec)
    jm, jp, p = _mech(tmp_path_factory, 'small')
    B = 8
    consts, meta = _consts_dd(jp, conp=conp, ext_gather=False,
                              compact_pdep=False)
    C = {k: jnp.asarray(v) for k, v in consts.items()}
    y, _, P = random_states(jm, B, seed=3)
    y64 = y.astype(np.float64)
    P64 = np.asarray(P if conp else np.full(B, 1.2), np.float64)
    yh = y64.T.astype(np.float32)
    yl = (y64.T - yh.astype(np.float64)).astype(np.float32)
    ph = P64[None].astype(np.float32)
    plo = (P64[None] - ph.astype(np.float64)).astype(np.float32)
    with df.barrier_mode('xla'):
        st = _compute_state_thermo(meta, C, DDA(jnp.asarray(yh),
                                                jnp.asarray(yl)),
                                   DDA(jnp.asarray(ph), jnp.asarray(plo)))
        rp = _compute_reaction_parts(meta, C, st)
        fin = _finish_dd(meta, C, st, rp)

    def val(x):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)

    st_p = state_thermo(p, torch.as_tensor(y64.T.copy()),
                        torch.as_tensor(P64[None].copy()), conp)
    for nm in ('T', 'rho', 'mw_avg', 'conc', 'smh', 'dsmh'):
        assert _row_rel(st_p[nm].numpy(), val(st[nm])) < 1e-12, nm
    roles = parts_reference(p, st_p, conp).numpy()
    Sf, Sp = p.reac_sp.shape[1], p.prod_sp.shape[1]
    names = ['vals_f%d' % s for s in range(Sf)]
    names += ['vals_p%d' % s for s in range(Sp)]
    names += ['q', 'dq_dT', 'c_u', 'c_1', 'psi_q', 'xi_q']
    jax_roles = _tiled_role_spec(meta)
    assert jax_roles == names[:len(jax_roles)]
    # elementwise roles to 1e-12; roles that carry a net rate of
    # progress (Rf - Rr) to 1e-9: the JAX side is 2^-48 double-float
    net = ('q', 'dq_dT', 'psi_q', 'xi_q')
    for i, nm in enumerate(names):
        if nm.startswith('vals_f'):
            ref = val(rp['vals_f'][int(nm[6:])])
        elif nm.startswith('vals_p'):
            ref = val(rp['vals_p'][int(nm[6:])])
        elif nm in jax_roles:
            ref = val(rp[nm])
        else:
            assert not roles[i].any(), nm      # no such category
            continue
        err = _row_rel(roles[i], ref)
        assert err < (1e-9 if nm in net else 1e-12), (nm, err)

    out = finish(p, st_p, torch.as_tensor(roles), conp)
    assert _row_rel(out['col0'].numpy(), val(fin['col0'])) < 1e-9
    assert _row_rel(out['f'].numpy(), val(fin['f_out'])) < 1e-9
    summed = ('v_u', 'v_c', 'fkJ', 'fT')
    for nm, (a, b) in post_rows(p.n_species, p.n_species - 1).items():
        err = _row_rel(out['post'][a:b].numpy(), val(fin[nm]))
        assert err < (1e-9 if nm in summed else 1e-12), (nm, err)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

SLICE_CASES = [
    # (mechanism, states, conp, BigJacobian options)
    *[(name, 8, conp, dict(sparse_cols=s))
      for name in ('synth', 'gri') for conp in (True, False)
      for s in (True, False)],
    *[('n_eq_r', 8, True, dict(sparse_cols=s)) for s in (True, False)],
    *[('usc', 4, True, dict(sparse_cols=s)) for s in (True, False)],
]


@pytest.mark.parametrize('name,B,conp,kw', SLICE_CASES, ids=[
    '%s-%s-%s' % (c[0], 'conp' if c[2] else 'conv',
                  '-'.join('%s%s' % (k, int(v)) for k, v in c[3].items()))
    for c in SLICE_CASES])
def test_slice_matches_jax_f64(tmp_path_factory, name, B, conp, kw):
    """J floored@1e-10 < 1e-10 and dy/dt norm-relative per state < 1e-9
    against the JAX f64 Jacobian; the pres-mod split, N == R and the
    USC-II class included.  At the USC-II
    class J is held to 2e-10: on these far-from-equilibrium states the
    port's plain dense ``jacobian_and_dydt`` itself differs from the JAX
    one by 7.6e-11 (reduction order, on entries near the 1e-10 floor)."""
    jm, jp, p = _mech(tmp_path_factory, name)
    y, _, P = random_states(jm, B, seed=3)
    P = P if conp else np.full(B, 1.2)           # CONV takes density
    bj = BigJacobian(p, conp=conp, device='cpu', **kw)
    n_pm = int(np.asarray(p.pres_mod_mask).sum())
    assert bj.split_r1 == (n_pm if 0 < n_pm < p.n_reactions else None)
    if name in ('synth', 'usc'):
        assert bj.split_r1
    J, f = bj(y, P)
    jJ, jf = jjacobian_and_dydt(jp, 0.0, jnp.asarray(P), jnp.asarray(y),
                                conp=conp)
    N = p.n_species
    assert J.shape == (B, N, N) and f.shape == (B, N)
    assert J.dtype == f.dtype == torch.float64
    tol_J = 2e-10 if name == 'usc' else 1e-10
    assert _floored(J.numpy(), np.asarray(jJ), 1e-10) < tol_J
    assert _norm_rel(f.numpy(), np.asarray(jf)) < 1e-9


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_golden(tmp_path_factory, name):
    """The reference-C goldens through the speed configuration, at the
    gates of ``test_golden_parity.py``'s golden classes: J floored@1e-10
    < 1e-8 and dy/dt norm-relative < 1e-7 (PaSR states sit near
    equilibrium, where net rates cancel to ~1e-9 of the gross fluxes)."""
    _, _, p = _mech(tmp_path_factory, name)
    g = np.load(DATA / ('golden_%s_refc.npz' % name))
    n = len(g['T'])
    J, f = BigJacobian(p, device='cpu')(g['y'], g['P'])
    Jl = J.numpy().transpose(0, 2, 1).reshape(n, -1)
    assert _floored(Jl, g['ref_jac'], 1e-10) < 1e-8
    assert _norm_rel(f.numpy(), g['ref_dydt']) < 1e-7
