"""The port's compressed sparse pipeline (``SparseJacobian``) against the
JAX package, on the CPU.

On CPU tensors ``SparseJacobian`` runs the plain versions of its two
CUDA kernels (``stage_a_reference`` / ``stage_b_reference``); these
tests hold those plain versions, and the tables the kernels read,
against the JAX package's ``PallasDDJacobianSparse`` tables, its dd
stage-A math (run eagerly under ``barrier_mode('xla')`` as
``tests/test_pallas_dd.py`` does, never jitted on the CPU), its f64
``jacobian_and_dydt``, and the reference-C goldens.  The kernels
themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``).
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops.dydt import dydt as jdydt
from pyjac_tpu.ops.jacobian import jacobian_and_dydt as jjacobian_and_dydt
from pyjac_tpu.testers.synthetic import (plausible_mechanism,
                                         random_states,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import pack
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt, reaction_parts
from pyjac_tpu_torch.ops.jacobian_big import parts_tables
from pyjac_tpu_torch.ops.jacobian_dense import dense_reference
from pyjac_tpu_torch.ops.jacobian_sparse import (SparseJacobian,
                                                 column_tables,
                                                 finish_tables,
                                                 kernel_tables,
                                                 post_rows,
                                                 stage_a_reference, supports)

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'
CSRC = pathlib.Path(__file__).resolve().parent.parent / 'pyjac_tpu_torch' / \
    'csrc'


def _both(tmp_path, text, name='m.inp'):
    path = tmp_path / name
    path.write_text(text)
    jm = JMechanism.from_files(str(path))
    m = Mechanism.from_files(str(path))
    return jm, jpack(jm), m, pack(m)


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    _, jp, _, p = _both(tmp_path_factory.mktemp('flag'),
                        plausible_mechanism(53, 325, seed=42))
    return jp, p, np.load(DATA / 'golden_flagship_refc.npz')


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    _, jp, _, p = _both(tmp_path_factory.mktemp('synth'),
                        synthetic_mechanism(n_species=9, n_reactions=24,
                                            seed=7))
    return jp, p, np.load(DATA / 'golden_synth_refc.npz')


@pytest.fixture(scope='module')
def synth53(tmp_path_factory):
    """The all-features synth at the flagship's width (53 species, 326
    reactions packed): PLOG, Chebyshev, SRI, chemically activated,
    species-specific pdep, fractional nu, third-body efficiencies."""
    jm, jp, _, p = _both(tmp_path_factory.mktemp('synth53'),
                         synthetic_mechanism(n_species=53, n_reactions=325,
                                             seed=7))
    return jm, jp, p


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
    scale = np.maximum(np.abs(b).max(-1), 1e-300)
    return float((np.abs(a - b).max(-1) / scale).max())


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def test_tables_match_jax_expanded_pack(flagship):
    """``gidx`` is the JAX role table exactly; ``nuc`` is the true f64
    signed stoichiometry the JAX table slices (``nuc * nu_rs``)."""
    from pyjac_tpu.ops.pallas_dd import (_consts_dd,
                                         _sparse_col_pack_expanded)
    jp, p, _ = flagship
    _, meta = _consts_dd(jp, compact_pdep=True)
    SC = _sparse_col_pack_expanded(jp, meta, jb=8)
    ct = column_tables(p)
    J = p.n_species - 1
    assert (ct['n_src'], ct['Rmax'], ct['S_eff']) == (SC['n_src'],
                                                      SC['Rmax'],
                                                      meta['S_eff'])
    assert (ct['n_src'], ct['Rmax'], len(ct['col_coef'])) == (1951, 56, 4553)
    assert np.array_equal(ct['gidx'], SC['gidx'][:J])
    ref = SC['nuc'].astype(np.float64) * SC['nu_rs'].astype(np.float64)
    assert np.array_equal(ct['nuc'], ref[:J])
    assert not len(SC['deep_cols'])
    # the stage-B CSR holds exactly the nonzeros of nuc
    ptr = ct['col_ptr']
    for j in (0, 17, J - 1):
        for n in range(p.n_species):
            a, b = ptr[j * p.n_species + n], ptr[j * p.n_species + n + 1]
            nz = np.nonzero(ct['nuc'][j, n])[0]
            assert np.array_equal(ct['col_src'][a:b], ct['gidx'][j, nz])
            assert np.array_equal(ct['col_coef'][a:b], ct['nuc'][j, n, nz])


def test_kernel_coverage(flagship, synth, synth53):
    """The CUDA kernels cover the flagship and both all-features synths
    (9/24 and 53/326: every category the JAX pipeline takes): the module
    checks nothing when it moves (it keeps ``nn.Module._apply``), and its
    kernel tables carry the categories."""
    p53 = synth53[2]
    assert p53.n_reactions == 326
    assert all(bool(x) for x in (
        p53.has_plog, p53.has_cheb, p53.has_sri, p53.has_chemact,
        p53.has_specific_pdep_sp, p53.has_frac_nu, p53.has_pres_mod))
    for p in (flagship[1], synth[1], p53):
        sj = SparseJacobian(p, device='cpu')
        assert type(sj)._apply is torch.nn.Module._apply
        assert sj.kp_flags.shape == (p.n_reactions,)


def test_slot_limit_still_raises_on_cuda(synth):
    """A table wider than the kernels' slot arrays (9 reactant slots,
    past ARRAY_SLOTS = 8) no longer raises anywhere: the kernels run
    their wide path on it (``csrc/kinetics.cuh``).  The padded slots
    change nothing: the plain version's outputs equal the unpadded
    mechanism's bit for bit."""
    p = synth[1]
    pad = ((0, 0), (0, 9 - p.reac_sp.shape[1]))
    wide = dataclasses.replace(
        p, reac_sp=np.pad(np.asarray(p.reac_sp), pad),
        reac_nu=np.pad(np.asarray(p.reac_nu), pad))
    sj = SparseJacobian(wide, device='cpu')
    assert sj.Sf == 9 and type(sj)._apply is torch.nn.Module._apply
    y = torch.as_tensor(synth[2]['y'][:4])
    P = torch.as_tensor(synth[2]['P'][:4])
    J, f = sj(y, P)
    J0, f0 = SparseJacobian(p, device='cpu')(y, P)
    assert torch.equal(J, J0) and torch.equal(f, f0)


def test_sign_flipping_plog_refused_as_jax(tmp_path):
    """A sign-flipping PLOG table (negative A inside a PLOG ladder) is
    refused as the JAX package's ``supports`` refuses it: on any device,
    ``SparseJacobian`` raises ``NotImplementedError``, as
    ``PallasDDJacobianSparse`` does."""
    from pyjac_tpu.ops.pallas_dd import PallasDDJacobianSparse
    from pyjac_tpu.ops.pallas_dd import supports as jsupports
    _, jp, _, p = _both(tmp_path, synthetic_mechanism(
        n_species=9, n_reactions=24, seed=7))
    assert supports(p) == jsupports(jp) is True
    assert p.has_plog
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    jbad = dataclasses.replace(jp, plog_sign=sign)
    bad = dataclasses.replace(p, plog_sign=sign)
    assert supports(bad) == jsupports(jbad) is False
    with pytest.raises(NotImplementedError, match='PLOG'):
        SparseJacobian(bad, device='cpu')
    with pytest.raises(NotImplementedError):
        PallasDDJacobianSparse(jbad, interpret=True)


def _struct_pointers(text, name):
    """The number of pointers a C struct ``name`` of the kernel sources
    declares, counting an embedded struct by its own count."""
    body = re.search(r'struct %s \{(.*?)\};' % name, text, re.S).group(1)
    n = 0
    for decl in body.split(';'):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r'(\w+)<\w+> \w+$', decl)
        n += (_struct_pointers(text, m.group(1)) if m else decl.count('*'))
    return n


def test_kernel_tables_are_k5s_plus_k1s(synth53):
    """K1's tables are K5's ``parts_tables`` (the same arrays, in
    ``PartsTables`` order), then the per-state phases' ``finish_tables``
    (K4's too), then ``eff_val``, then ``rxn_order``: K4's reaction order,
    a permutation of the reactions grouped by category (flags, PLOG,
    Chebyshev), ascending within a group; the module registers them in
    that order, and their count is the C struct ``StageATables``'
    (``N_TABLES``)."""
    p = synth53[2]
    want = [('kp_' + k, v) for k, v in parts_tables(p).items()]
    want += [('kf_' + k, v) for k, v in finish_tables(p).items()]
    tabs = kernel_tables(p)
    assert [k for k, _ in want] + ['ka_eff_val', 'ka_rxn_order'] == \
        list(tabs)
    for k, v in want:
        assert np.array_equal(tabs[k], v) and tabs[k].dtype == v.dtype, k
    assert tabs['ka_eff_val'].shape == (p.n_reactions * 3,)
    order = tabs['ka_rxn_order']
    R = p.n_reactions
    assert order.dtype == np.int32 and np.array_equal(np.sort(order),
                                                      np.arange(R))
    pt = parts_tables(p)
    key = (pt['flags'].astype(np.int64) | (pt['plog_pos'] >= 0) << 8 |
           (pt['cheb_pos'] >= 0) << 9)[order]
    assert (np.diff(key) >= 0).all() and len(np.unique(key)) > 8
    same = np.diff(key) == 0
    assert (np.diff(order)[same] > 0).all()
    sj = SparseJacobian(p, device='cpu')
    names = [k for k in sj._buffers if k[:3] in ('kp_', 'kf_', 'ka_')]
    assert names == list(tabs)
    for k in names:
        assert np.array_equal(sj._buffers[k].numpy(), tabs[k]), k
    text = (CSRC / 'kinetics.cuh').read_text() + \
        (CSRC / 'sparse_stage_a.cu').read_text()
    assert _struct_pointers(text, 'PartsTables') == len(parts_tables(p)) == \
        int(re.search(r'#define N_PARTS_TABLES (\d+)', text).group(1))
    assert _struct_pointers(text, 'FinishTables') == len(finish_tables(p)) \
        == int(re.search(r'#define N_FINISH_TABLES (\d+)', text).group(1))
    assert _struct_pointers(text, 'StageATables') == len(tabs)
    assert re.search(r'#define N_TABLES \(N_PARTS_TABLES \+ '
                     r'N_FINISH_TABLES \+ 2\)', text)


# ---------------------------------------------------------------------------
# K1's tile (kernels.stage_a_tile_rows, kernels.tile_plan): what the card's
# launch asks for, computed on the host
# ---------------------------------------------------------------------------

# the large classes K1 is held at on the card: (N, R, seed) of the port's
# plausible_mechanism
TILE_MECHS = {'usc': (111, 784, 5), '654': (654, 2716, 5)}
_TILE_PACKED = {}


def _tile_packed(request, name):
    """The port's packed mechanism ``name``: a fixture's, or a large
    class's."""
    at = {'flagship': 1, 'synth': 1, 'synth53': 2}     # the fixtures' p
    if name in at:
        return request.getfixturevalue(name)[at[name]]
    if name not in _TILE_PACKED:
        from pyjac_tpu_torch.testers.synthetic import (
            packed_from_text, plausible_mechanism as port_plausible)
        N, R, seed = TILE_MECHS[name]
        _TILE_PACKED[name] = packed_from_text(port_plausible(N, R,
                                                             seed=seed))[1]
    return _TILE_PACKED[name]


@pytest.mark.parametrize('name, rows', [
    ('flagship', 2272), ('synth', 269), ('synth53', 2603), ('usc', 5263),
    ('654', 21439)])
def test_stage_a_tile_rows_hold_the_plain_pieces(request, name, rows):
    """A state's K1 tile rows (``stage_a_tile_rows``; the kernel's
    ``stage_a_layout`` checks the count at launch) are the plain
    version's per-state arrays that K1 does not write straight out: y
    and P, 4 state scalars, the state/thermo rows (which later hold
    omega, domega and the closure's 2 sums), the role array less its
    slot roles (which go to the source stack) and, where no reaction has
    species-specific pdep, its xi_q rows, the post rows, and h and dcp.
    The planner counts the same."""
    from pyjac_tpu_torch.ops.jacobian_big import (finish, parts_reference,
                                                  state_thermo)
    from pyjac_tpu_torch.testers.synthetic import random_states as prs
    p = _tile_packed(request, name)
    y, _, P = prs(p.mech, 2, seed=3)
    y_t = torch.as_tensor(y.T.copy())
    P_t = torch.as_tensor(np.asarray(P)[None].copy())
    st = state_thermo(p, y_t, P_t, True)
    roles = parts_reference(p, st, True)
    post = finish(p, st, roles, True)['post']
    N, R = p.n_species, p.n_reactions
    k = p.reac_sp.shape[1] + p.prod_sp.shape[1]
    spec = bool(p.has_specific_pdep_sp)
    assert st['rows'].shape[0] >= 2 * N + 2
    want = (N + 1) + 4 + st['rows'].shape[0] + \
        (roles.shape[0] - k - (not spec)) * R + post.shape[0] + 2 * N
    assert kernels.stage_a_tile_rows(N, R, spec) == want == rows
    sj = SparseJacobian(p, device='cpu')
    assert kernels.tile_plan(sj, torch.float64, 64)['rows'] == want


@pytest.mark.parametrize('name, tile', [
    ('flagship', 8), ('synth53', 8), ('usc', 4), ('654', 1)])
def test_stage_a_tile_plan(request, name, tile):
    """K1 keeps a tile of states' rows in shared memory, one block a tile
    and no global scratch: as many states as fit one block's 227 KB and
    leave a spare group of its 512 threads (at most 512 / (N + 1)),
    rounded down to a multiple of 4 (4 f64 states a 32 B sector: the
    stores of its source and post rows are then whole sectors) where 4
    fit: the flagship 8 (12 fit, 9 leave a spare group), the 53/326
    synth 8 of 20.3 KB, USC-II 4 of 41.1 KB; the 654 class, 167.5 KB a
    state, one (on the card one state a tile in shared memory beat the
    global slices by a third: PERF.md)."""
    p = _tile_packed(request, name)
    sj = SparseJacobian(p, device='cpu')
    B = 131072
    plan = kernels.tile_plan(sj, torch.float64, B)
    rows = plan['rows']
    assert (plan['tile'], plan['placement']) == (tile, 'shared')
    fit = min(kernels.SMEM_MAX // (rows * 8),
              max(1, 512 // (p.n_species + 1)))
    assert tile == (fit // 4 * 4 if fit >= 4 else fit)
    assert plan['scratch_elems'] == 0
    assert plan['smem_bytes'] == rows * tile * 8 <= kernels.SMEM_MAX
    assert plan['grid'] == B // tile + (B % tile > 0)


def test_stage_a_global_plan(request):
    """Under the global placement (a mechanism too large for shared
    memory, or asked for) K1's tile rows live in one global slice per
    SM, sized to fit the L2 together, the 132 blocks looping over the
    tiles: 4 flagship states a slice, one 654-class state."""
    for name, tile in (('flagship', 4), ('654', 1)):
        sj = SparseJacobian(_tile_packed(request, name), device='cpu')
        plan = kernels.tile_plan(sj, torch.float64, 131072,
                                 placement='global')
        assert (plan['tile'], plan['placement']) == (tile, 'global')
        assert plan['smem_bytes'] == 0 and plan['grid'] == 132
        assert plan['scratch_elems'] == 132 * tile * plan['rows']
        assert plan['scratch_elems'] * 8 <= kernels.L2_SLICES


def test_stage_a_tile_plan_ragged_and_overrides(flagship):
    """A ragged batch takes one more tile; a tile / placement given
    overrides the planner's choice (4 and 12 states a tile; the global
    placement: 132 slices of 4 states); a tile that does not fit shared
    memory, no tile, and an unknown placement raise."""
    sj = SparseJacobian(flagship[1], device='cpu')
    plan = kernels.tile_plan(sj, torch.float64, 4099)
    assert (plan['tile'], plan['grid']) == (8, 513)
    for tile, grid in ((4, 1025), (12, 342)):
        other = kernels.tile_plan(sj, torch.float64, 4099, tile=tile)
        assert (other['grid'], other['smem_bytes']) == (
            grid, tile * 8 * plan['rows'])
    g = kernels.tile_plan(sj, torch.float64, 4099, placement='global')
    assert (g['tile'], g['placement'], g['grid']) == (4, 'global', 132)
    assert g['scratch_elems'] == 132 * 4 * g['rows']
    with pytest.raises(ValueError, match='shared memory'):
        kernels.tile_plan(sj, torch.float64, 4099, tile=13)
    with pytest.raises(ValueError, match='a tile holds'):
        kernels.tile_plan(sj, torch.float64, 4099, tile=0)
    with pytest.raises(ValueError, match='placement'):
        kernels.tile_plan(sj, torch.float64, 4099, placement='l2')


def test_kernel_launchers_refuse_cpu_tensors(flagship):
    """No fallback: a kernel launcher given CPU tensors raises, builds
    nothing and counts no launch."""
    sj = SparseJacobian(flagship[1], device='cpu')
    y_t = torch.zeros((sj.N, 4), dtype=torch.float64)
    P_t = torch.ones((1, 4), dtype=torch.float64)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.stage_a(sj, y_t, P_t)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.stage_b(sj, torch.zeros((sj.n_src, 4), dtype=torch.float64),
                        torch.zeros((sj.n_post, 4), dtype=torch.float64))
    assert kernels.launches == before and kernels._lib is None


# ---------------------------------------------------------------------------
# stage A against the JAX dd stage-A math
# ---------------------------------------------------------------------------

def test_stage_a_matches_jax_dd_parts(tmp_path):
    from pyjac_tpu.ops import doublefloat as df
    from pyjac_tpu.ops.pallas_dd import (DDA, PallasDDJacobianSparse,
                                         _compute_dd, _postcol_stream_spec,
                                         _stack_expanded_src)
    jm, jp, m, p = _both(tmp_path, synthetic_mechanism(
        n_species=6, n_reactions=10, seed=7, gri_mix=True))
    B = 8
    pjs = PallasDDJacobianSparse(jp, block_b=8, block_b_cols=8, jb=4,
                                 fuse_gather=True, interpret=True)
    y, _, P = random_states(jm, B)
    y64, P64 = y.astype(np.float64), np.asarray(P, np.float64)
    yh = y64.T.astype(np.float32)
    yl = (y64.T - yh.astype(np.float64)).astype(np.float32)
    ph = P64[None].astype(np.float32)
    plo = (P64[None] - ph.astype(np.float64)).astype(np.float32)
    C = {k: jnp.asarray(v) for k, v in pjs.consts.items()}
    with df.barrier_mode('xla'):
        parts = _compute_dd(pjs.meta, C, DDA(jnp.asarray(yh),
                                             jnp.asarray(yl)),
                            DDA(jnp.asarray(ph), jnp.asarray(plo)))
        src = _stack_expanded_src(pjs.meta, C, parts)

    def val(x):
        return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)

    out = stage_a_reference(p, torch.as_tensor(y64.T.copy()),
                            torch.as_tensor(P64[None].copy()))
    sj = SparseJacobian(p, device='cpu')
    R = p.n_reactions
    n_vals = (sj.Sf + sj.Sp) * R
    got_src = out['src'].numpy()
    ref_src = val(src)
    assert got_src.shape == ref_src.shape == (pjs.SC['n_src'], B)
    # per-slot values: elementwise, 1e-12; psi_q rows carry the net rate
    # (Rf - Rr) and the third-body sum: 1e-9 (the JAX side is 2^-48 dd)
    assert _row_rel(got_src[:n_vals], ref_src[:n_vals]) < 1e-12
    assert _row_rel(got_src[n_vals:], ref_src[n_vals:]) < 1e-9
    assert _row_rel(out['col0'].numpy(), val(parts['col0'])) < 1e-9
    assert _row_rel(out['f'].numpy(), val(parts['f_out'])) < 1e-9
    rows = post_rows(p.n_species, p.n_species - 1)
    summed = ('v_u', 'v_c', 'fkJ', 'fT')
    names = [nm for nm, _ in _postcol_stream_spec(pjs.meta)]
    assert sorted(names) == sorted(rows)
    for nm in names:
        a, b = rows[nm]
        err = _row_rel(out['post'][a:b].numpy(), val(parts[nm]))
        assert err < (1e-9 if nm in summed else 1e-12), (nm, err)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def test_slice_matches_jax_f64(flagship):
    """32 flagship golden states: J floored@1e-10 < 1e-10 (what the JAX
    f64 path is held to against reference C) and dy/dt < 1e-7."""
    jp, p, g = flagship
    y, P = g['y'][:32], g['P'][:32]
    J, f = SparseJacobian(p, device='cpu')(y, P)
    jJ, jf = jjacobian_and_dydt(jp, 0.0, jnp.asarray(P), jnp.asarray(y))
    assert J.shape == (32, 53, 53) and f.shape == (32, 53)
    assert J.dtype == f.dtype == torch.float64
    assert _floored(J.numpy(), np.asarray(jJ), 1e-10) < 1e-10
    assert _norm_rel(f.numpy(), np.asarray(jf)) < 1e-7


def test_slice_synth53_matches_jax_f64(synth53):
    """The all-features synth at the flagship's width (53/326), 8 of its
    random states: J floored@1e-10 < 1e-10 and dy/dt < 1e-7 against the
    JAX package's f64 ``jacobian_and_dydt`` (as
    :func:`test_slice_matches_jax_f64`)."""
    jm, jp, p = synth53
    y, _, P = random_states(jm, 8, seed=3)
    J, f = SparseJacobian(p, device='cpu')(y, P)
    jJ, jf = jjacobian_and_dydt(jp, 0.0, jnp.asarray(P), jnp.asarray(y))
    assert J.shape == (8, 53, 53)
    assert _floored(J.numpy(), np.asarray(jJ), 1e-10) < 1e-10
    assert _norm_rel(f.numpy(), np.asarray(jf)) < 1e-7


def test_plain_f_rows_match_jax_dydt_to_roundoff(flagship):
    """On 256 flagship PaSR states the plain versions' dy/dt (stage A's
    and K4's, one finish) agree with the JAX package's f64 ``dydt`` to
    roundoff on the summed magnitude of each species row's terms,
    sum_r |nu_rn| |pm_r| (|Rf_r| + |Rr_r|) W_n / rho (reads 5.7e-15),
    though per row, on the row's own scale, they differ by up to ~3e-9:
    those rows cancel up to ~1e7-fold near equilibrium, so any two
    summation orders of omega = nu^T q differ there."""
    _, p, _ = flagship
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:256], d['P'][:256]
    y_t, P_t = torch.as_tensor(y.T.copy()), torch.as_tensor(P[None].copy())
    fa = stage_a_reference(p, y_t, P_t)['f']
    fd = dense_reference(p, y_t, P_t)[1]
    assert torch.equal(fa, fd)
    fj = np.asarray(jdydt(flagship[0], 0.0, jnp.asarray(P),
                          jnp.asarray(y))).T
    rp = reaction_parts(p, torch.as_tensor(P), torch.as_tensor(y))
    q_gross = (rp['pm'].abs() * (rp['Rf'].abs() + rp['Rr'].abs())).numpy()
    nu = np.abs(np.asarray(p.nu_net, np.float64))
    gross = ((q_gross @ nu) * np.asarray(p.mw) /
             rp['rho'].numpy()[:, None]).T[:-1]
    diff = np.abs(fa.numpy()[1:] - fj[1:])
    assert float((diff / gross).max()) < 1e-13
    assert _row_rel(fa.numpy()[1:], fj[1:]) > 1e-10


def test_slice_flagship_golden(flagship):
    """All 128 flagship golden states against pyJac's generated C:
    J (reference column-major layout) floored@1e-10 < 1e-8, dy/dt
    norm-relative < 1e-7 (``tests/test_golden_parity.py:255-274``)."""
    _, p, g = flagship
    n = len(g['T'])
    J, f = SparseJacobian(p, device='cpu')(g['y'], g['P'])
    Jl = J.numpy().transpose(0, 2, 1).reshape(n, -1)
    assert _floored(Jl, g['ref_jac'], 1e-10) < 1e-8
    assert _norm_rel(f.numpy(), g['ref_dydt']) < 1e-7


def test_slice_synth_golden(synth):
    """The all-features golden (PLOG, Chebyshev, SRI, chemically
    activated, fractional nu) through the sparse path, at
    ``TestAllFeaturesGolden``'s tolerances."""
    _, p, g = synth
    n = len(g['T'])
    J, f = SparseJacobian(p, device='cpu')(g['y'], g['P'])
    Jl = J.numpy().transpose(0, 2, 1).reshape(n, -1)
    assert _floored(Jl, g['ref_jac'], 1e-9) < 1e-8
    assert _floored(f.numpy(), g['ref_dydt'], 1e-9) < 1e-10


@pytest.mark.parametrize('conp', [True, False])
def test_slice_matches_plain_jacobian(synth, conp):
    """Sparse and dense plain paths of the port agree, CONP and CONV,
    on every category."""
    _, p, g = synth
    y = torch.as_tensor(g['y'][:32])
    P = torch.as_tensor(g['P'][:32])
    J, f = SparseJacobian(p, conp=conp, device='cpu')(y, P)
    J0, f0 = jacobian_and_dydt(p, 0.0, P, y, conp=conp)
    assert _floored(J.numpy(), J0.numpy(), 1e-10) < 1e-10
    assert _norm_rel(f.numpy(), f0.numpy()) < 1e-12


# ---------------------------------------------------------------------------
# fuse_gather=False: the gather, then K2x
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_unfused_gather_is_bit_equal(flagship, synth, name):
    """``fuse_gather=False`` (gather, then K2x's plain version) gives J
    and f bit-equal to the fused path on the CPU."""
    _, p, g = flagship if name == 'flagship' else synth
    y, P = g['y'][:32], g['P'][:32]
    J1, f1 = SparseJacobian(p, device='cpu')(y, P)
    J0, f0 = SparseJacobian(p, fuse_gather=False, device='cpu')(y, P)
    assert torch.equal(J0, J1) and torch.equal(f0, f1)


def test_stage_gather_matches_jax_take(tmp_path):
    """The unfused path's operand is the JAX pipeline's ``stage_gather``
    (``jnp.take`` of the source stack at the expanded role table's rows)
    on the 6/10 synth."""
    from pyjac_tpu.ops.pallas_dd import _consts_dd, _sparse_col_pack_expanded
    jm, jp, m, p = _both(tmp_path, synthetic_mechanism(
        n_species=6, n_reactions=10, seed=7, gri_mix=True))
    y, _, P = random_states(jm, 8)
    src = stage_a_reference(p, torch.as_tensor(y.T.copy()),
                            torch.as_tensor(P[None].copy()))['src']
    _, meta = _consts_dd(jp, compact_pdep=True)
    SC = _sparse_col_pack_expanded(jp, meta, jb=8)
    J = p.n_species - 1
    ref = jnp.take(jnp.asarray(src.numpy()),
                   jnp.asarray(SC['gidx'][:J].reshape(-1)), axis=0)
    sj = SparseJacobian(p, fuse_gather=False, device='cpu')
    got = sj.stage_gather(src)
    assert got.shape == (J * sj.Rmax, 8)
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_k2x_csr_stays_in_its_column_block(flagship, synth, name):
    """K2x (K6's kernel) reads column j's operand rows [j*Rmax,
    (j+1)*Rmax) of the gathered operand alone, so each column's CSR
    entries must point inside that block, and they carry exactly the
    nonzeros of ``nuc[j]``, row by row."""
    p = (flagship if name == 'flagship' else synth)[1]
    sj = SparseJacobian(p, fuse_gather=False, device='cpu')
    cell = torch.repeat_interleave(torch.arange(sj.J * sj.N),
                                   torch.diff(sj.kx_ptr.long()))
    col, row = cell // sj.N, cell % sj.N
    src = sj.kx_src.long()
    assert bool((src // sj.Rmax == col).all())
    assert torch.equal(sj.kx_coef, sj.nuc[col, row, src % sj.Rmax])
    assert int((sj.nuc != 0).sum()) == len(src)


def test_k2x_launcher_refuses_cpu_tensors(flagship):
    sj = SparseJacobian(flagship[1], fuse_gather=False, device='cpu')
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.stage_b_x(sj, torch.zeros((sj.J * sj.Rmax, 4),
                                          dtype=torch.float64),
                          torch.zeros((sj.n_post, 4), dtype=torch.float64))
    assert kernels.launches == before and kernels._lib is None


def test_chip_smoke_rehearsal_and_no_card(tmp_path):
    """Without a card ``chip_smoke.py`` fails before printing a result,
    both from the repository and alone in an empty directory."""
    import shutil
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present; the smoke runs for real')
    repo = pathlib.Path(__file__).resolve().parent.parent
    shutil.copy(repo / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    for cwd in (repo, tmp_path):
        out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=str(cwd),
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and '"ok"' not in out.stdout, out.stdout
