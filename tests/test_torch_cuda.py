"""The port's CUDA kernels on the card (``-m cuda``).

Every test here needs a CUDA card and skips without one.  The file
imports neither jax nor the JAX package, so it also runs where JAX is
not installed; ``tests/conftest.py`` imports jax, so run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import collections
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from pyjac_tpu_torch.core.constants import RU
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import pack
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.dydt import dydt
from pyjac_tpu_torch.integrate import (FLOOR_ROWS, STATUS_SUCCESS, integrate,
                                       lu_factor, lu_solve)
from pyjac_tpu_torch.ops.jacobian_big import (BigJacobian,
                                              cols_dense_reference,
                                              cols_sparse_reference, finish,
                                              p1_dense, parts_reference,
                                              source_stack, state_thermo)
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian, dense_reference
from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian, f32_reference
from pyjac_tpu_torch.ops.jacobian_sparse import (SparseJacobian, post_rows,
                                                 stage_a_reference,
                                                 stage_b_reference)
from pyjac_tpu_torch.testers.synthetic import (flagship, packed_from_text,
                                               plausible_mechanism,
                                               random_states,
                                               synthetic_mechanism,
                                               wide_mechanism)

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


def _floored(a, b, floor):
    a, b = a.reshape(len(b), -1), b.reshape(len(b), -1)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


def test_kernels_match_cpu_on_card(card):
    """The module on the card launches both kernels once and agrees with
    its CPU run (the plain versions) on the flagship golden states."""
    _, p = flagship()
    g = np.load(DATA / 'golden_flagship_refc.npz')
    J0, f0 = SparseJacobian(p, device='cpu')(g['y'], g['P'])
    kernels.reset_launches()
    J, f = SparseJacobian(p, device=card)(g['y'], g['P'])
    torch.cuda.synchronize(card)
    assert kernels.launches == {'stage_a': 1, 'stage_b': 1, 'stage_b_x': 0,
                                'big_parts': 0, 'big_cols_sparse': 0,
                                'big_cols_dense': 0, 'dense_fused': 0,
                                'fused_f32': 0, 'lu_factor': 0,
                                'lu_solve': 0, 'dydt': 0}
    assert J.device == card and J.dtype == torch.float64
    assert _floored(J.cpu().numpy(), J0.numpy(), 1e-10) < 1e-9
    f, f0 = f.cpu().numpy(), f0.numpy()
    assert (np.abs(f - f0).max(-1) / np.abs(f0).max(-1)).max() < 1e-8


def test_launch_spans_hold_the_kernels(card, tmp_path):
    """One K1 + K2 call under ``profiling.trace``: one ``pyjac.jacobian``
    span, a ``pyjac.kernels.prepare`` (K1's with a ``plan``, each with an
    ``alloc``) and a ``pyjac.kernels.launch`` a kernel.  On the card's
    timeline each launch span covers exactly its kernel, no other span
    of a launcher covers any, and the operators' records still hold the
    kernels' device time (what ``stage_a_ms`` / ``stage_b_ms`` read)."""
    from torch.autograd import DeviceType
    from pyjac_tpu_torch import profiling
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    sj = SparseJacobian(p, device=card)
    y_t = torch.as_tensor(d['y'][:256].T.copy(), device=card)
    P_t = torch.as_tensor(d['P'][None, :256].copy(), device=card)
    sj.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    with profiling.trace(str(tmp_path / 'trace')) as prof:
        sj.call_tr(y_t, P_t)
    ev = prof.events()
    host = [e for e in ev if e.device_type == DeviceType.CPU]
    assert collections.Counter(e.name for e in host
                               if e.name.startswith('pyjac.')) == {
        'pyjac.jacobian': 1, 'pyjac.kernels.prepare': 2,
        'pyjac.kernels.plan': 1, 'pyjac.kernels.alloc': 2,
        'pyjac.kernels.launch': 2}
    on_card = [e for e in ev if e.device_type == DeviceType.CUDA]
    kern = sorted((e.time_range.start, e.time_range.end) for e in on_card
                  if 'sparse_stage_a' in e.name or 'sparse_stage_b' in e.name)
    launch = sorted((e.time_range.start, e.time_range.end) for e in on_card
                    if e.name == 'pyjac.kernels.launch')
    assert len(kern) == 2 and launch == kern
    assert not [e for e in on_card if e.name in (
        'pyjac.kernels.prepare', 'pyjac.kernels.plan', 'pyjac.kernels.alloc')]
    ops = sum(e.device_time_total for e in host if e.name in (
        'pyjac_tpu_torch::stage_a', 'pyjac_tpu_torch::stage_b'))
    assert ops == pytest.approx(sum(b - a for a, b in kern), rel=1e-6)


@pytest.mark.parametrize('B', [1, 333])
def test_ragged_batch_on_card(card, B):
    """Batches that are no multiple of a thread block: the kernels mask
    the ragged edge."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:B], d['P'][:B]
    J0, f0 = SparseJacobian(p, device='cpu')(y, P)
    J, f = SparseJacobian(p, device=card)(y, P)
    assert _floored(J.cpu().numpy(), J0.numpy(), 1e-10) < 1e-9
    f, f0 = f.cpu().numpy(), f0.numpy()
    assert (np.abs(f - f0).max(-1) / np.abs(f0).max(-1)).max() < 1e-8


def test_all_features_on_card_matches_cpu(card, tmp_path):
    """The all-features synth (PLOG, Chebyshev, SRI, chemically activated,
    species-specific pdep, fractional nu) through ``SparseJacobian`` on
    the card launches K1 and K2 once and agrees with its CPU run on the
    synth golden states."""
    path = tmp_path / 'synth.inp'
    path.write_text(synthetic_mechanism(n_species=9, n_reactions=24, seed=7))
    p = pack(Mechanism.from_files(str(path)))
    g = np.load(DATA / 'golden_synth_refc.npz')
    J0, f0 = SparseJacobian(p, device='cpu')(g['y'], g['P'])
    kernels.reset_launches()
    J, f = SparseJacobian(p, device=card)(g['y'], g['P'])
    torch.cuda.synchronize(card)
    assert (kernels.launches['stage_a'], kernels.launches['stage_b']) == \
        (1, 1)
    assert _floored(J.cpu().numpy(), J0.numpy(), 1e-10) < 1e-9
    f, f0 = f.cpu().numpy(), f0.numpy()
    assert (np.abs(f - f0).max(-1) / np.abs(f0).max(-1)).max() < 1e-8


def test_slot_limit_refuses_card(card):
    """More reactant slots than the kernels' slot arrays (9, past
    ARRAY_SLOTS = 8): the module moves to the card, and K1 + K2 run the
    wide path, agreeing with the unpadded mechanism's plain version."""
    _, p = flagship()
    pad = ((0, 0), (0, 9 - p.reac_sp.shape[1]))
    wide = dataclasses.replace(
        p, reac_sp=np.pad(np.asarray(p.reac_sp), pad),
        reac_nu=np.pad(np.asarray(p.reac_nu), pad))
    g = np.load(DATA / 'golden_flagship_refc.npz')
    J0, f0 = SparseJacobian(p, device='cpu')(g['y'], g['P'])
    kernels.reset_launches()
    J, f = SparseJacobian(wide, device='cpu').to(card)(g['y'], g['P'])
    torch.cuda.synchronize(card)
    assert (kernels.launches['stage_a'], kernels.launches['stage_b']) == \
        (1, 1)
    assert _floored(J.cpu().numpy(), J0.numpy(), 1e-10) < 1e-9
    f, f0 = f.cpu().numpy(), f0.numpy()
    assert (np.abs(f - f0).max(-1) / np.abs(f0).max(-1)).max() < 1e-8


def test_launchers_check_inputs(card):
    _, p = flagship()
    sj = SparseJacobian(p, device=card)
    y_t = torch.zeros((sj.N, 256), dtype=torch.float64, device=card)
    P_t = torch.ones((1, 256), dtype=torch.float64, device=card)
    with pytest.raises(ValueError, match='float64'):
        kernels.stage_a(sj, y_t.float(), P_t)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.stage_a(sj, y_t.T.contiguous().T, P_t)
    with pytest.raises(ValueError, match='shape'):
        kernels.stage_b(sj, torch.zeros((sj.n_src + 1, 256),
                                        dtype=torch.float64, device=card),
                        torch.zeros((sj.n_post, 256), dtype=torch.float64,
                                    device=card))


def _assert_stage_a_close(got, ref):
    """K1's outputs against ``stage_a_reference``'s on the same states:
    each source row within 1e-9 of its largest entry (its psi_q and
    xi_q rows carry net rates, which cancel), col0 and f per state within
    1e-8 (the repo's dy/dt metric; their temperature row on its own),
    each post row within 1e-8 of its largest entry per state."""
    def rows(a, b):
        return float(((a - b).abs().amax(-1) /
                      b.abs().amax(-1).clamp_min(1e-300)).max())

    def states(a, b):
        return float(((a - b).abs().amax(0) /
                      b.abs().amax(0).clamp_min(1e-300)).max())

    assert rows(got['src'], ref['src']) < 1e-9
    for k in ('col0', 'f'):
        assert rows(got[k][:1], ref[k][:1]) < 1e-8, k
        assert states(got[k][1:], ref[k][1:]) < 1e-8, k
    assert states(got['post'], ref['post']) < 1e-8


def _n_sm(card):
    return torch.cuda.get_device_properties(card).multi_processor_count


@pytest.mark.parametrize('placement', ['shared', 'global'])
@pytest.mark.parametrize('conp', [True, False])
def test_stage_a_placements_on_card(card, placement, conp):
    """K1 with its tiles in shared memory and in global slices, on 1001
    flagship states (no multiple of a tile: the last is ragged), agrees
    with ``stage_a_reference`` and, bit for bit, with the planner's own
    launch: a state's arithmetic does not depend on its tile."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:1001], d['P'][:1001]
    if not conp:
        P = _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), device=card)
    sj = SparseJacobian(p, conp=conp, device=card)
    plan = kernels.tile_plan(sj, torch.float64, 1001, _n_sm(card),
                             placement=placement)
    assert plan['placement'] == placement and 1001 % plan['tile']
    kernels.reset_launches()
    got = kernels.stage_a(sj, y_t, P_t, plan=plan)
    own = sj.stage_a(y_t, P_t)
    torch.cuda.synchronize(card)
    assert kernels.launches['stage_a'] == 2
    assert all(torch.equal(got[k], own[k]) for k in got)
    _assert_stage_a_close(got, stage_a_reference(p, y_t, P_t, conp))


def test_stage_a_654_class_on_card(card):
    """The 654-species class through K1 (167.5 KB a state: the planner's
    one state a tile in shared memory) agrees with ``stage_a_reference``
    on 5 states, and the global placement's slices give the same outputs
    bit for bit."""
    _, p = packed_from_text(plausible_mechanism(654, 2716, seed=5))
    y, _, P = random_states(p.mech, 5, seed=3)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(P[None].copy(), device=card)
    sj = SparseJacobian(p, device=card)
    plan = kernels.tile_plan(sj, torch.float64, 5, _n_sm(card))
    assert (plan['tile'], plan['placement']) == (1, 'shared')
    got = sj.stage_a(y_t, P_t)
    glob = kernels.stage_a(sj, y_t, P_t, plan=kernels.tile_plan(
        sj, torch.float64, 5, _n_sm(card), placement='global'))
    torch.cuda.synchronize(card)
    assert all(torch.equal(got[k], glob[k]) for k in got)
    _assert_stage_a_close(got, stage_a_reference(p, y_t, P_t, True))


def test_stage_a_refuses_a_wrong_plan(card):
    """K1's launcher checks a plan's rows against the kernel's own layout,
    and the C entry refuses a tile larger than shared memory takes;
    neither launches."""
    _, p = flagship()
    sj = SparseJacobian(p, device=card)
    y_t = torch.zeros((sj.N, 256), dtype=torch.float64, device=card)
    P_t = torch.ones((1, 256), dtype=torch.float64, device=card)
    plan = kernels.tile_plan(sj, torch.float64, 256, _n_sm(card))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match='tile rows mismatch'):
        kernels.stage_a(sj, y_t, P_t, plan=dict(plan, rows=plan['rows'] + 1))
    big = dict(plan, tile=kernels.SMEM_MAX // (plan['rows'] * 8) + 1, grid=1)
    assert big['rows'] * big['tile'] * 8 > kernels.SMEM_MAX
    with pytest.raises(RuntimeError, match='invalid dimensions'):
        kernels.stage_a(sj, y_t, P_t, plan=big)
    assert kernels.launches['stage_a'] == 0


# ---------------------------------------------------------------------------
# the large-mechanism pipeline (K5, K6, K7)
# ---------------------------------------------------------------------------

def _big_pair(p, y, P, **kw):
    """(J, f) of BigJacobian on the CPU (plain versions) and on the card,
    and the card run's launch counts."""
    J0, f0 = BigJacobian(p, device='cpu', **kw)(y, P)
    kernels.reset_launches()
    J, f = BigJacobian(p, device='cuda', **kw)(y, P)
    torch.cuda.synchronize()
    return J0.numpy(), f0.numpy(), J.cpu().numpy(), f.cpu().numpy(), dict(
        kernels.launches)


def test_big_parts_two_slots_match_run_time_on_card(card):
    """K5's 2 + 2 instantiation (the flagship's slot counts fixed at
    compile time) and its run-time slot loops (the flagship padded to 3
    reactant slots: the extra slot has nu 0, so every product and
    derivative is unchanged) give the same role rows bit for bit on 1001
    PaSR states, the padded slot's row aside."""
    _, p = flagship()
    pad = ((0, 0), (0, 1))
    wide = dataclasses.replace(p, reac_sp=np.pad(np.asarray(p.reac_sp), pad),
                               reac_nu=np.pad(np.asarray(p.reac_nu), pad))
    d = np.load(DATA / 'flagship_states.npz')
    y_t = torch.as_tensor(d['y'][:1001].T.copy(), device=card)
    P_t = torch.as_tensor(d['P'][None, :1001].copy(), device=card)
    roles = []
    for q in (p, wide):
        bj = BigJacobian(q, device=card)
        roles.append(bj.parts(state_thermo(bj.packed, y_t, P_t, True)))
    torch.cuda.synchronize(card)
    two, run = roles
    assert (two.shape[0], run.shape[0]) == (10, 11)
    assert torch.equal(two[:2], run[:2]) and torch.equal(two[2:], run[3:])


@pytest.mark.parametrize('kw', [{}, dict(sparse_cols=False)])
def test_big_matches_cpu_on_card(card, kw):
    """BigJacobian on the card launches K5 (twice: the pres-mod rows are
    split off) and K6 (or K7) and agrees with its CPU run on the flagship
    golden states."""
    _, p = flagship()
    g = np.load(DATA / 'golden_flagship_refc.npz')
    J0, f0, J, f, n = _big_pair(p, g['y'], g['P'], **kw)
    cols = 'big_cols_sparse' if kw.get('sparse_cols', True) else \
        'big_cols_dense'
    assert n['big_parts'] == 2 and n[cols] >= 1
    assert _floored(J, J0, 1e-10) < 1e-9
    assert (np.abs(f - f0).max(-1) / np.abs(f0).max(-1)).max() < 1e-8


@pytest.mark.parametrize('conp', [True, False])
def test_big_ragged_and_conv_on_card(card, conp):
    """A batch of 1000 states (no multiple of a thread block), CONP and
    CONV (density = each state's own), on the all-features synth."""
    _, p = packed_from_text(synthetic_mechanism(n_species=9, n_reactions=24,
                                                seed=7))
    y, _, P = random_states(p.mech, 1000, seed=3)
    if not conp:
        Yf = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)],
                            1)
        P = P / (RU * y[:, 0] * (Yf * p.inv_mw).sum(1))
    J0, f0, J, f, _ = _big_pair(p, y, P, conp=conp)
    assert _floored(J, J0, 1e-10) < 1e-9
    assert (np.abs(f - f0).max(-1) / np.abs(f0).max(-1)).max() < 1e-8


def test_big_reassigned_table_on_card(card):
    """K5's launcher keeps its gathered tables and their checked
    pointers while the module's buffers are the same tensors: a table
    buffer replaced after a call is passed anew, not as the freed
    address."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:256], d['P'][:256]
    bj = BigJacobian(p, device=card)
    J1, f1 = bj(y, P)
    bj.kp_logA = bj.kp_logA.clone()
    torch.cuda.empty_cache()
    J2, f2 = bj(y, P)
    assert torch.equal(J1, J2) and torch.equal(f1, f2)


def _t_row_gross(dcol, inv_mw, post, conp):
    """(J, B): the summed magnitude of the terms each column's temperature
    row adds (``post_col_reference``'s N terms eWn * dcol and its fT
    term), from the plain raw contraction ``dcol``."""
    N = dcol.shape[1]
    J = N - 1
    g = {k: post[a:b] for k, (a, b) in post_rows(N, J).items()}
    w = inv_mw[:J]
    u = w - inv_mw[N - 1]
    d = (dcol * w[:, None, None] + g['v_u'][None] * u[:, None, None] +
         g['v_c'][None])
    r = -(g['mw_avg'] * u[:, None]) if conp else 0.0
    return ((g['eWn'][None] * d).abs().sum(1) +
            (g['fT'] * (r + (g['cp'][:J] - g['cp'][N - 1]) * g['ish'])).abs())


# (mechanism, kernel): J = 8 (synth) and 52 (flagship), neither a multiple
# of K7's 16 columns per block, 52 none of K6's 8
COLUMN_CASES = [('synth', 'K6'), ('synth', 'K7'), ('flagship', 'K6'),
                ('flagship', 'K7'), ('flagship', 'K2x')]


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('name,kern', COLUMN_CASES,
                         ids=['-'.join(c) for c in COLUMN_CASES])
def test_column_kernels_match_plain_on_card(card, name, kern, conp):
    """K6, K7 and K2x each launch once and agree with their plain versions
    on the same inputs at a ragged batch (1000 states: no multiple of a
    block's states), CONP and CONV: J's species rows floored@1e-10 <=
    1e-9, its temperature row <= 1e-12 of the summed magnitude of its
    terms (chip_smoke.py's TOL_BIG_J and TOL_BIG_JT)."""
    B = 1000
    if name == 'flagship':
        _, p = flagship()
        d = np.load(DATA / 'flagship_states.npz')
        y, P = d['y'][:B], d['P'][:B]
    else:
        _, p = packed_from_text(synthetic_mechanism(n_species=9,
                                                    n_reactions=24, seed=7))
        y, _, P = random_states(p.mech, B, seed=3)
    if not conp:
        P = _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), device=card)
    if kern == 'K2x':
        mod = SparseJacobian(p, conp=conp, fuse_gather=False, device=card)
        a = stage_a_reference(p, y_t, P_t, conp)
        post = a['post']
        p1 = mod.stage_gather(a['src'])
        rows = torch.arange(mod.J * mod.Rmax, device=card).view(mod.J,
                                                                mod.Rmax)
        plain = stage_b_reference(rows, mod.nuc, mod.inv_mw, p1, post, conp)
        dcol = torch.einsum('jnr,jrb->jnb', mod.nuc, p1.view(mod.J, mod.Rmax,
                                                             B))
        kernels.reset_launches()
        got = mod.stage_b_x(p1, post)
        name_k = 'stage_b_x'
    else:
        mod = BigJacobian(p, conp=conp, sparse_cols=kern == 'K6',
                          device=card)
        st = state_thermo(mod.packed, y_t, P_t, conp)
        roles = parts_reference(mod.packed, st, conp)
        post = finish(mod.packed, st, roles, conp)['post']
        k = mod.Sf + mod.Sp
        if kern == 'K6':
            p1c = mod.assemble_p1c(source_stack(roles, k, mod.eff_val))
            plain = cols_sparse_reference(p1c, mod.ks_nuc, mod.inv_mw, post,
                                          conp)
            dcol = torch.einsum('jnr,jrb->jnb', mod.ks_nuc,
                                p1c.view(mod.J, mod.Rmax, B))
        else:
            t = mod.tab('kd_')
            plain = cols_dense_reference(roles, t, mod.inv_mw, post, conp)
            dcol = torch.stack([t['nu_net'].T @ p1_dense(
                roles, mod.Sf, mod.Sp, t['spf'], t['spp'], t['eff'],
                t['pd'], j) for j in range(mod.J)], 0)
        kernels.reset_launches()
        got = mod.columns(roles, post)
        name_k = 'big_cols_sparse' if kern == 'K6' else 'big_cols_dense'
    torch.cuda.synchronize(card)
    assert kernels.launches[name_k] == 1
    assert got.shape == plain.shape == (mod.J, mod.N, B)
    gross = _t_row_gross(dcol, mod.inv_mw, post, conp)
    assert float(((got[:, 0] - plain[:, 0]).abs() / gross).max()) <= 1e-12
    bmax = plain.abs().reshape(-1, B).amax(0)
    e = (got - plain).abs() / torch.maximum(plain.abs(), bmax * 1e-10)
    assert float(e[:, 1:].max()) <= 1e-9


# ---------------------------------------------------------------------------
# the dense fused kernel K4, K2x and the integrator
# ---------------------------------------------------------------------------

def _density(p, y, P):
    """Each state's own density (CONV takes density)."""
    Yf = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)], 1)
    return P / (RU * y[:, 0] * (Yf * p.inv_mw).sum(1))


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('conp', [True, False])
def test_dense_fused_matches_plain_on_card(card, name, conp):
    """K4 launches once per call and agrees with ``dense_reference`` on
    the same inputs on the card: J floored@1e-10 < 1e-9, dy/dt
    norm-relative per state < 1e-8 (333 flagship states, 1000 synth
    states: no multiple of a block)."""
    if name == 'flagship':
        _, p = flagship()
        d = np.load(DATA / 'flagship_states.npz')
        y, P = d['y'][:333], d['P'][:333]
    else:
        _, p = packed_from_text(synthetic_mechanism(n_species=9,
                                                    n_reactions=24, seed=7))
        y, _, P = random_states(p.mech, 1000, seed=3)
    if not conp:
        P = _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), device=card)
    dj = DenseJacobian(p, conp=conp, device=card)
    kernels.reset_launches()
    Jt, f = dj.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    assert kernels.launches['dense_fused'] == 1
    Jr, fr = dense_reference(p, y_t, P_t, conp)
    n = y.shape[0]
    Jt, Jr = Jt.permute(2, 1, 0).cpu().numpy(), Jr.permute(2, 1, 0).cpu()
    assert _floored(Jt, Jr.numpy(), 1e-10) < 1e-9
    f, fr = f.T.cpu().numpy(), fr.T.cpu().numpy()
    assert f.shape == (n, p.n_species)
    assert (np.abs(f - fr).max(-1) / np.abs(fr).max(-1)).max() < 1e-8


@pytest.mark.parametrize('placement', ['shared', 'global'])
@pytest.mark.parametrize('conp', [True, False])
def test_dense_fused_placements_on_card(card, placement, conp):
    """K4 with its tiles in shared memory and in global slices, on 1001
    flagship states (no multiple of a tile: the last is ragged), agrees
    with ``dense_reference`` (J floored@1e-10 < 1e-9, dy/dt norm-relative
    per state < 1e-8) and, bit for bit, with the planner's own launch: a
    state's arithmetic does not depend on its tile."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:1001], d['P'][:1001]
    if not conp:
        P = _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), device=card)
    dj = DenseJacobian(p, conp=conp, device=card)
    plan = kernels.tile_plan(
        dj, torch.float64, 1001,
        torch.cuda.get_device_properties(card).multi_processor_count,
        placement=placement)
    assert plan['placement'] == placement and 1001 % plan['tile']
    kernels.reset_launches()
    Jt, f = kernels.dense_fused(dj, y_t, P_t, plan=plan)
    J0, f0 = dj.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    assert kernels.launches['dense_fused'] == 2
    assert torch.equal(Jt, J0) and torch.equal(f, f0)
    Jr, fr = dense_reference(p, y_t, P_t, conp)
    assert _floored(Jt.permute(2, 1, 0).cpu().numpy(),
                    Jr.permute(2, 1, 0).cpu().numpy(), 1e-10) < 1e-9
    f, fr = f.T.cpu().numpy(), fr.T.cpu().numpy()
    assert (np.abs(f - fr).max(-1) / np.abs(fr).max(-1)).max() < 1e-8


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_dense_fused_654_class_on_card(card, dtype):
    """The 654-species class through K4 (its rows exceed shared memory:
    the planner's global slices) and K3 (one state a tile in shared
    memory) agrees with its plain version on 5 states: K4 J
    floored@1e-10 < 1e-9, K3 the JAX package's f32 metric."""
    _, p = packed_from_text(plausible_mechanism(654, 2716, seed=5))
    y, _, P = random_states(p.mech, 5, seed=3)
    y_t = torch.as_tensor(y.T.copy(), dtype=dtype, device=card)
    P_t = torch.as_tensor(P[None].copy(), dtype=dtype, device=card)
    mod = (DenseJacobian if dtype == torch.float64 else F32Jacobian)(
        p, device=card)
    plan = kernels.tile_plan(mod, dtype, 5)
    assert (plan['tile'], plan['placement']) == (
        (1, 'global') if dtype == torch.float64 else (1, 'shared'))
    Jt, f = mod.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    if dtype == torch.float64:
        Jr, fr = dense_reference(p, y_t, P_t, True)
        assert _floored(Jt.permute(2, 1, 0).cpu().numpy(),
                        Jr.permute(2, 1, 0).cpu().numpy(), 1e-10) < 1e-9
        assert float(((f - fr).abs().amax(0) / fr.abs().amax(0)).max()) \
            < 1e-8
    else:
        Jr, fr = f32_reference(p, y_t, P_t, True)
        for got, ref in ((Jt, Jr), (f, fr)):
            share, err = _f32_err(got, ref)
            assert share >= 0.995 and err < 2e-5, (share, err)


def test_stage_b_x_matches_plain_on_card(card):
    """``SparseJacobian(fuse_gather=False)`` runs K1, the gather and K2x
    (not K2); K2x agrees with ``stage_b_reference`` on the same stage-A
    outputs and with the fused path's J."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y_t = torch.as_tensor(d['y'][:1000].T.copy(), device=card)
    P_t = torch.as_tensor(d['P'][None, :1000].copy(), device=card)
    sx = SparseJacobian(p, fuse_gather=False, device=card)
    kernels.reset_launches()
    cols, _, _ = sx.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    assert (kernels.launches['stage_a'], kernels.launches['stage_b'],
            kernels.launches['stage_b_x']) == (1, 0, 1)
    a = stage_a_reference(p, y_t, P_t)
    got = sx.stage_b_x(sx.stage_gather(a['src']), a['post'])
    ref = stage_b_reference(sx.gidx, sx.nuc, sx.inv_mw, a['src'], a['post'])
    assert _floored(got.permute(2, 0, 1).cpu().numpy(),
                    ref.permute(2, 0, 1).cpu().numpy(), 1e-10) < 1e-9
    fused, _, _ = SparseJacobian(p, device=card).call_tr(y_t, P_t)
    assert _floored(cols.permute(2, 0, 1).cpu().numpy(),
                    fused.permute(2, 0, 1).cpu().numpy(), 1e-10) < 1e-9


@pytest.mark.parametrize('method', ['ros23', 'rodas3'])
def test_integrate_dd_matches_xla_on_card(card, method):
    """A short integration on the card: ``jacobian='dd'`` launches K4 once
    per loop iteration and takes the same steps as ``jacobian='xla'``,
    with endpoints floored@1e-10 within 1e-9."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:64], d['P'][:64]
    kernels.reset_launches()
    rd = integrate(p, y, P, 1e-5, jacobian='dd', method=method)
    assert kernels.launches['dense_fused'] == rd.iterations > 0
    rx = integrate(p, y, P, 1e-5, jacobian='xla', method=method)
    assert rd.y.device == card
    assert bool((rd.status == STATUS_SUCCESS).all())
    assert torch.equal(rd.steps, rx.steps)
    assert torch.equal(rd.rejected, rx.rejected)
    assert _floored(rd.y.cpu().numpy(), rx.y.cpu().numpy(), 1e-10) < 1e-9


def test_integrate_working_set_is_per_state_on_card(card):
    """The gri30 class's 4032 PaSR states over the integrate cell's flow
    step (1e-4 s, ROS23, rtol 1e-6, atol 1e-10, ``jacobian='dd'``): the
    loop re-compacts, and more than 60% of the rows it computes belong
    to states still integrating (100 attempts / rows).  K4, the dy/dt
    kernel, the LU kernels and the row-wise torch ops compute each state
    alone at any working-set size and position: four slices of
    ``FLOOR_ROWS`` states, each integrated as a batch of its own (one
    size, every row computed every iteration), end bit for bit where
    they end in the whole batch, and a random permutation of the batch
    gives the permuted steps, rejections and status exactly, its
    endpoints within 1e-12 floored."""
    from torch.profiler import ProfilerActivity, profile
    from pyjac_tpu_torch import profiling
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'], d['P']
    kw = dict(jacobian='dd', method='ros23', rtol=1e-6, atol=1e-10)
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = integrate(p, y, P, 1e-4, **kw)
    c = dict(profiling.counters)
    profiling.counters.clear()
    assert c['integrate.compactions'] >= 2
    assert 100.0 * c['integrate.state_attempts'] / \
        c['integrate.state_slots'] > 60.0
    perm = np.random.default_rng(21).permutation(len(y))
    shuffled = integrate(p, y[perm], P[perm], 1e-4, **kw)
    pt = torch.as_tensor(perm, device=card)
    for k in ('steps', 'rejected', 'status'):
        assert torch.equal(getattr(res, k)[pt], getattr(shuffled, k)), k
    assert _floored(shuffled.y.cpu().numpy(), res.y[pt].cpu().numpy(),
                    1e-10) < 1e-12
    for start in (0, 1000, 2222, len(y) - FLOOR_ROWS):
        cut = slice(start, start + FLOOR_ROWS)
        part = integrate(p, y[cut], P[cut], 1e-4, **kw)
        for k in ('y', 't', 'steps', 'rejected', 'status'):
            assert torch.equal(getattr(res, k)[cut], getattr(part, k)), \
                (start, k)


def _lu_inputs(card, B):
    """K4's flagship Jt (N, N, B) on B tiled PaSR states, and per-state
    step scales s = h gamma, log-uniform over [1e-11, 3e-5] (the
    integrate cell's range)."""
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    idx = np.arange(B) % len(d['y'])
    y_t = torch.as_tensor(d['y'][idx].T.copy(), device=card)
    P_t = torch.as_tensor(d['P'][None, idx].copy(), device=card)
    Jt, _ = DenseJacobian(p, device=card).call_tr(y_t, P_t)
    s = 10.0 ** np.random.default_rng(17).uniform(-11, np.log10(3e-5), B)
    return Jt, torch.as_tensor(s, device=card)


def _library_lu(J, s):
    return torch.linalg.lu_factor_ex(_iteration_matrix(J, s),
                                     check_errors=False)


def _iteration_matrix(J, s):
    return torch.eye(J.shape[-1], dtype=J.dtype, device=J.device) - \
        s[:, None, None] * J


def _forward_error(x, W, rhs, ref):
    """The largest error of each state's solve x over its largest |x|,
    against the exact solution: ``ref`` (an f64 solve) after one step of
    refinement with its residual in numpy's extended precision."""
    Wl = W.cpu().numpy().astype(np.longdouble)
    xl = ref.cpu().numpy().astype(np.longdouble)
    r = rhs.cpu().numpy().astype(np.longdouble) - np.einsum('bij,bj->bi',
                                                            Wl, xl)
    dx = np.linalg.solve(W.cpu().numpy(), r.astype(np.float64)[..., None])
    exact = (xl + dx[..., 0]).astype(np.float64)
    xn = x.cpu().numpy()
    return float((np.abs(xn - exact).max(-1) / np.abs(exact).max(-1)).max())


@pytest.mark.parametrize('layout', ['dd', 'xla'])
def test_lu_kernel_matches_library_on_card(card, layout):
    """The LU kernels on W = I - s J from K4's flagship output at B =
    4099 (a ragged last tile), J read where K4 leaves it ([column, row,
    batch], ``dd``) or as a contiguous (B, N, N) copy (``xla``), against
    ``torch.linalg.lu_factor_ex`` / ``lu_solve`` of the same W on the
    card: the same pivots and ok, LU within 1e-12 of each state's largest
    |LU|, and solves no farther from the exact solution than twice the
    farther of the library's on the card and on the CPU (the plain
    version), each over the state's largest |x|: at these step sizes W is
    ill-conditioned, and the f64 solvers part ~1e-10 from one another;
    one launch each; each state's factor bit-equal where it sits
    elsewhere in its tile (the batch shifted by one state); the operators
    under opcheck."""
    Jt, s = _lu_inputs(card, 4099)
    J = Jt.permute(2, 1, 0)
    if layout == 'xla':
        J = J.contiguous()
    LUr, pivr, info = _library_lu(J, s)
    rhs = torch.as_tensor(
        np.random.default_rng(5).standard_normal((4099, J.shape[-1])),
        device=card)
    xr = torch.linalg.lu_solve(LUr, pivr, rhs[..., None])[..., 0]
    kernels.reset_launches()
    fac = lu_factor(J, s)
    x = lu_solve(fac, rhs)
    torch.cuda.synchronize(card)
    assert (kernels.launches['lu_factor'], kernels.launches['lu_solve']) \
        == (1, 1)
    LU, piv, ok = fac
    assert LU.shape == (4099, 53, 53) and piv.shape == (4099, 53)
    assert torch.equal(piv, pivr)
    assert torch.equal(ok, info == 0) and bool(ok.all())
    assert float(((LU - LUr).abs().amax((1, 2)) /
                  LUr.abs().amax((1, 2))).max()) < 1e-12
    W = _iteration_matrix(J, s)
    LUc, pivc, _ = torch.linalg.lu_factor_ex(W.cpu())
    xc = torch.linalg.lu_solve(LUc, pivc, rhs.cpu()[..., None])[..., 0]
    err, err_lib, err_cpu = (_forward_error(x, W, rhs, xr),
                             _forward_error(xr, W, rhs, xr),
                             _forward_error(xc, W, rhs, xr))
    assert err <= 2.0 * max(err_lib, err_cpu), (err, err_lib, err_cpu)
    assert all(torch.equal(a, b[1:])
               for a, b in zip(lu_factor(J[1:], s[1:]), fac))
    ops = torch.ops.pyjac_tpu_torch
    torch.library.opcheck(ops.lu_factor.default, (J[:333], s[:333]))
    torch.library.opcheck(ops.lu_solve.default,
                          (LU[:333], piv[:333], rhs[:333]))


def test_lu_kernel_flags_singular_and_nan_on_card(card):
    """A W with a zero column gives ``ok`` False, as the library's info,
    and solves that are not finite; a state with a NaN in J gives solves
    that are not finite; every other state is flagged and solved as the
    library does."""
    Jt, s = _lu_inputs(card, 64)
    J = Jt.permute(2, 1, 0).contiguous()
    s[3] = 1.0
    J[3, :, 5] = 0.0
    J[3, 5, 5] = 1.0           # column 5 of W = I - J is zero
    J[7, 2, 9] = float('nan')
    fac = lu_factor(J, s)
    rhs = torch.ones((64, J.shape[-1]), dtype=J.dtype, device=card)
    x = lu_solve(fac, rhs)
    LUr, pivr, info = _library_lu(J, s)
    xr = torch.linalg.lu_solve(LUr, pivr, rhs[..., None])[..., 0]
    rest = [b for b in range(64) if b != 7]
    assert torch.equal(fac[2][rest], (info == 0)[rest])
    assert not bool(fac[2][3]) and int(fac[2][rest].sum()) == 62
    finite = torch.isfinite(x).all(-1)
    assert not bool(finite[3]) and not bool(finite[7])
    assert int(finite.sum()) == 62
    good = [b for b in rest if b != 3]
    W = _iteration_matrix(J[good], s[good])
    assert _forward_error(x[good], W, rhs[good], xr[good]) <= \
        2.0 * _forward_error(xr[good], W, rhs[good], xr[good])


def test_lu_above_the_on_chip_limit_takes_the_library(card):
    """An N past ``kernels.LU_MAX_N`` (one block's shared memory) takes
    the library on the card, chosen by N: no LU launch, the library's
    factors and solve exactly."""
    N, B = kernels.LU_MAX_N + 1, 6
    rng = np.random.default_rng(3)
    J = torch.as_tensor(rng.standard_normal((B, N, N)), device=card)
    s = torch.as_tensor(rng.uniform(0.01, 0.1, B), device=card)
    rhs = torch.as_tensor(rng.standard_normal((B, N)), device=card)
    kernels.reset_launches()
    fac = lu_factor(J, s)
    x = lu_solve(fac, rhs)
    torch.cuda.synchronize(card)
    assert (kernels.launches['lu_factor'], kernels.launches['lu_solve']) \
        == (0, 0)
    LUr, pivr, info = _library_lu(J, s)
    assert torch.equal(fac[0], LUr) and torch.equal(fac[1], pivr)
    assert torch.equal(fac[2], info == 0)
    assert torch.equal(
        x, torch.linalg.lu_solve(LUr, pivr, rhs[..., None])[..., 0])


@pytest.mark.parametrize('jacobian', ['dd', 'xla'])
@pytest.mark.parametrize('method,solves', [('ros23', 3), ('rodas3', 4)])
def test_integrate_lu_launches_on_card(card, jacobian, method, solves):
    """An integration on the card factors once an iteration and solves
    once a stage with the LU kernels, and counts each factor under
    ``integrate.lu_kernel`` while a profiler records."""
    from torch.profiler import ProfilerActivity, profile
    from pyjac_tpu_torch import profiling
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:64], d['P'][:64]
    kernels.reset_launches()
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = integrate(p, y, P, 1e-5, jacobian=jacobian, method=method)
    assert bool((res.status == STATUS_SUCCESS).all())
    n = res.iterations
    assert n > 0
    assert kernels.launches['lu_factor'] == n
    assert kernels.launches['lu_solve'] == solves * n
    assert profiling.counters['integrate.lu_kernel'] == n
    profiling.counters.clear()


# ---------------------------------------------------------------------------
# the dy/dt kernel (csrc/dydt.cu) and the integrator's f
# ---------------------------------------------------------------------------

# the mechanisms the dy/dt kernel is held at beside the flagship: USC-II's
# class, the all-features synth at the flagship's width (PLOG, Chebyshev,
# SRI, chemically activated, species-specific pdep, fractional nu) and
# the wide path's mechanism
DYDT_MECHS = {'usc': lambda: plausible_mechanism(111, 784, seed=5),
              'synth53': lambda: synthetic_mechanism(53, 326, seed=7),
              'wide': wide_mechanism}


def _dydt_case(name, B, conp, card):
    """(packed, y (B, N), param (B,)) on the card: the flagship's PaSR
    states (tiled to B), else the mechanism's ``random_states(seed=3)``;
    param is pressure (CONP) or each state's density (CONV)."""
    if name == 'flagship':
        _, p = flagship()
        d = np.load(DATA / 'flagship_states.npz')
        reps = -(-B // len(d['y']))
        y, P = np.tile(d['y'], (reps, 1))[:B], np.tile(d['P'], reps)[:B]
    else:
        _, p = packed_from_text(DYDT_MECHS[name]())
        y, _, P = random_states(p.mech, B, seed=3)
    if not conp:
        P = _density(p, y, P)
    return (p, torch.as_tensor(y, device=card),
            torch.as_tensor(np.asarray(P), device=card))


@pytest.mark.parametrize('B', [1, 333, 32768])
@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('name', ['flagship', 'usc', 'synth53', 'wide'])
def test_dydt_kernel_is_k4_f_on_card(card, name, conp, B):
    """The dy/dt kernel launches once a call and gives K4's f bit for
    bit, on the (N, B) states K4 takes and on the transposed view of
    (B, N) states (the integrator's), its f laid out as its input; and
    it is within the tolerance K4's f is held to (norm-relative per
    state < 1e-8) of the plain ``dydt``."""
    p, y, P = _dydt_case(name, B, conp, card)
    dj = DenseJacobian(p, conp=conp, device=card)
    y_t, P_t = y.T.contiguous(), P[None].contiguous()
    _, fk = dj.call_tr(y_t, P_t)
    kernels.reset_launches()
    f = kernels.dydt(dj, y_t, P_t)
    fv = kernels.dydt(dj, y.T, P_t)
    torch.cuda.synchronize(card)
    assert kernels.launches['dydt'] == 2
    assert f.stride() == y_t.stride() and fv.stride() == y.T.stride()
    assert torch.equal(f, fk) and torch.equal(fv, fk)
    fr = dydt(p, 0.0, P, y, conp=conp)
    err = (fv.T - fr).abs().amax(1) / fr.abs().amax(1)
    assert float(err.max()) < 1e-8


@pytest.mark.parametrize('placement', ['shared', 'global'])
@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
def test_dydt_kernel_placements_on_card(card, placement, conp):
    """The dy/dt kernel with its tiles in shared memory and in global
    slices, on 1001 flagship states (the last tile ragged), gives the
    planner's own launch and K4's f bit for bit: a state's arithmetic
    does not depend on its tile."""
    p, y, P = _dydt_case('flagship', 1001, conp, card)
    dj = DenseJacobian(p, conp=conp, device=card)
    plan = kernels.tile_plan(dj, torch.float64, 1001, _n_sm(card),
                             placement=placement, kernel='dydt')
    assert plan['placement'] == placement and 1001 % plan['tile']
    P_t = P[None].contiguous()
    f = kernels.dydt(dj, y.T, P_t, plan=plan)
    assert torch.equal(f, kernels.dydt(dj, y.T, P_t))
    assert torch.equal(f.T, dj.call_tr(y.T.contiguous(), P_t)[1].T)


def test_dydt_kernel_654_class_on_card(card):
    """The 654-species class: the dy/dt kernel keeps 3 states a tile in
    shared memory where K4 needs global slices, and its f is K4's bit
    for bit."""
    _, p = packed_from_text(plausible_mechanism(654, 2716, seed=5))
    y, _, P = random_states(p.mech, 5, seed=3)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(P[None].copy(), device=card)
    dj = DenseJacobian(p, device=card)
    plan = kernels.tile_plan(dj, torch.float64, 5, kernel='dydt')
    assert (plan['tile'], plan['placement']) == (3, 'shared')
    assert kernels.tile_plan(dj, torch.float64, 5)['placement'] == 'global'
    assert torch.equal(kernels.dydt(dj, y_t, P_t), dj.call_tr(y_t, P_t)[1])


def test_dydt_operator_opcheck_on_card(card):
    """``pyjac_tpu_torch::dydt`` under ``torch.library.opcheck`` on the
    card (its launch beside its fake implementation: schema, shapes,
    dtypes, strides, dynamic batch) on the 9/24 all-features synth, a
    ragged B, with (N, B) states and with the transposed view of (B, N)
    states."""
    mech, p = packed_from_text(synthetic_mechanism(9, 24, seed=7))
    y, _, P = random_states(mech, 333, seed=3)
    y = torch.as_tensor(y, device=card)
    P_t = torch.as_tensor(P[None].copy(), device=card)
    dj = DenseJacobian(p, device=card)
    for y_t in (y.T.contiguous(), y.T):
        torch.library.opcheck(torch.ops.pyjac_tpu_torch.dydt.default,
                              (*kernels.dense_inputs(dj, torch.float64),
                               y_t, P_t))


@pytest.mark.parametrize('method', ['ros23', 'rodas3'])
@pytest.mark.parametrize('jacobian,per_iteration', [('dd', 2), ('xla', 3)])
def test_integrate_dydt_launches_on_card(card, jacobian, per_iteration,
                                         method):
    """On the card the integrator's f comes from kernels: with
    ``jacobian='dd'`` a step's f(y) is K4's and its other stages' the
    dy/dt kernel's (2 launches an iteration); with ``'xla'`` every f is
    the dy/dt kernel's (3).  ``integrate.dydt_kernel`` counts each while
    a profiler records, and every dy/dt span holds the kernel alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pyjac_tpu_torch import profiling
    _, p = flagship()
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][:64], d['P'][:64]
    kernels.reset_launches()
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = integrate(p, y, P, 1e-5, jacobian=jacobian, method=method)
        torch.cuda.synchronize(card)
    assert bool((res.status == STATUS_SUCCESS).all())
    n = res.iterations
    assert n > 0
    assert kernels.launches['dydt'] == per_iteration * n
    assert profiling.counters['integrate.dydt_kernel'] == per_iteration * n
    assert kernels.launches['dense_fused'] == (n if jacobian == 'dd' else 0)
    profiling.counters.clear()
    spans = [e for e in prof.events()
             if e.name == 'pyjac.integrate.dydt' and
             e.device_type == DeviceType.CPU]
    assert len(spans) == per_iteration * n

    def kernels_under(e):
        return [k.name for k in e.kernels] + [
            k for c in e.cpu_children for k in kernels_under(c)]

    for e in spans:
        names = kernels_under(e)
        assert len(names) == 1 and 'dydt_kernel' in names[0], names


def test_integrate_refused_mechanism_keeps_the_plain_f_on_card(card):
    """A mechanism ``DenseJacobian`` refuses (a sign-flipping PLOG table)
    integrates under ``jacobian='xla'`` on the card with the plain f: no
    dy/dt kernel launches."""
    _, p = packed_from_text(synthetic_mechanism(9, 24, seed=7))
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    bad = dataclasses.replace(p, plog_sign=sign)
    y, _, P = random_states(p.mech, 8, seed=3)
    kernels.reset_launches()
    res = integrate(bad, y, P, 1e-7, jacobian='xla')
    assert res.iterations > 0
    assert kernels.launches['dydt'] == 0


def test_dense_launcher_refuses_cpu_tensors(card):
    _, p = flagship()
    dj = DenseJacobian(p, device=card)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dense_fused(dj, torch.zeros((dj.N, 4), dtype=torch.float64),
                            torch.ones((1, 4), dtype=torch.float64))


# ---------------------------------------------------------------------------
# the float32 fused kernel K3
# ---------------------------------------------------------------------------

def _f32_err(a, b):
    """(finite share, max |a - b| on entries finite in both / the largest
    |b| there): the JAX package's f32 metric."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (float(fin.double().mean()),
            float((a - b).abs()[fin].max() / b.abs()[fin].max()))


def _f32_own(a, b, floor):
    """max |a - b| of (N, B) float32 rows, each state (column) on its own
    largest |b| entry, floored at ``floor`` of it, over the entries finite
    on both sides."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    a, b = torch.where(fin, a, 0.0), torch.where(fin, b, 0.0)
    denom = torch.maximum(b.abs(), b.abs().amax(0) * floor + 1e-300)
    return float(((a - b).abs() / denom).max())


@pytest.mark.parametrize('B', [1, 333])
@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('conp', [True, False])
def test_fused_f32_matches_plain_on_card(card, name, conp, B):
    """K3 launches once per call and agrees with ``f32_reference`` on the
    same float32 inputs on the card (B = 1 and 333: no multiple of a
    block): the JAX package's f32 metric (J and f at 2e-5 of the batch's
    largest entry on the entries finite on both sides, finite share >=
    0.995), and each state on its own scales: J's species rows floored at
    1e-3 of the state's largest species-row entry < 1e-3, J's temperature
    row floored at 1e-3 of the state's largest entry there < 1e-3, dy/dt's
    species rows per state < 1e-4 (its temperature row on the batch's)."""
    if name == 'flagship':
        mech, p = flagship()
        y, _, P = random_states(mech, B, seed=1, T_range=(1500.0, 2500.0))
    else:
        mech, p = packed_from_text(synthetic_mechanism(n_species=9,
                                                       n_reactions=24,
                                                       seed=7))
        y, _, P = random_states(mech, B, seed=3)
    if not conp:
        P = _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy(), dtype=torch.float32, device=card)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), dtype=torch.float32,
                          device=card)
    fj = F32Jacobian(p, conp=conp, device=card)
    kernels.reset_launches()
    Jt, f = fj.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    assert kernels.launches['fused_f32'] == 1
    assert Jt.dtype == f.dtype == torch.float32
    Jr, fr = f32_reference(p, y_t, P_t, conp)
    for got, ref in ((Jt, Jr), (f, fr)):
        share, err = _f32_err(got, ref)
        assert share >= 0.995 and err < 2e-5, (share, err)
    N = p.n_species
    assert _f32_own(Jt[:, 1:].reshape(-1, B), Jr[:, 1:].reshape(-1, B),
                    1e-3) < 1e-3
    assert _f32_own(Jt[:, 0], Jr[:, 0], 1e-3) < 1e-3
    assert _f32_own(f[1:], fr[1:], 1.0) < 1e-4
    assert float((f[0] - fr[0]).abs().max() / fr[0].abs().max()) < 1e-4
    assert Jt.shape == (N, N, B)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_dense_fused_three_reactant_slots_on_card(card, dtype):
    """The flagship padded to 3 reactant slots takes the kernels' general
    slot loops (2 + 2 slots are unrolled) and agrees with its plain
    version on 333 states (the PaSR states in f64, the f32 cell's draw in
    f32): K4 J floored@1e-10 < 1e-9, K3 the JAX package's f32 metric."""
    mech, p = flagship()
    pad = ((0, 0), (0, 1))
    p = dataclasses.replace(p, reac_sp=np.pad(np.asarray(p.reac_sp), pad),
                            reac_nu=np.pad(np.asarray(p.reac_nu), pad))
    if dtype == torch.float64:
        d = np.load(DATA / 'flagship_states.npz')
        y, P = d['y'][:333], d['P'][:333]
    else:
        y, _, P = random_states(mech, 333, seed=1, T_range=(1500.0, 2500.0))
    y_t = torch.as_tensor(y.T.copy(), dtype=dtype, device=card)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), dtype=dtype,
                          device=card)
    if dtype == torch.float64:
        Jt, f = DenseJacobian(p, device=card).call_tr(y_t, P_t)
        Jr, fr = dense_reference(p, y_t, P_t, True)
        assert _floored(Jt.permute(2, 1, 0).cpu().numpy(),
                        Jr.permute(2, 1, 0).cpu().numpy(), 1e-10) < 1e-9
    else:
        Jt, f = F32Jacobian(p, device=card).call_tr(y_t, P_t)
        Jr, fr = f32_reference(p, y_t, P_t, True)
        for got, ref in ((Jt, Jr), (f, fr)):
            share, err = _f32_err(got, ref)
            assert share >= 0.995 and err < 2e-5, (share, err)


@pytest.mark.parametrize('placement', ['shared', 'global'])
def test_fused_f32_placements_on_card(card, placement):
    """K3 under each placement on 1001 f32-cell states (no multiple of a
    tile) is bit-equal to the planner's own launch and meets the JAX
    package's f32 metric against ``f32_reference``."""
    mech, p = flagship()
    y, _, P = random_states(mech, 1001, seed=1, T_range=(1500.0, 2500.0))
    y_t = torch.as_tensor(y.T.copy(), dtype=torch.float32, device=card)
    P_t = torch.as_tensor(P[None].copy(), dtype=torch.float32, device=card)
    fj = F32Jacobian(p, device=card)
    plan = kernels.tile_plan(
        fj, torch.float32, 1001,
        torch.cuda.get_device_properties(card).multi_processor_count,
        placement=placement)
    assert plan['placement'] == placement and 1001 % plan['tile']
    Jt, f = kernels.fused_f32(fj, y_t, P_t, plan=plan)
    J0, f0 = fj.call_tr(y_t, P_t)
    torch.cuda.synchronize(card)
    assert torch.equal(Jt, J0) and torch.equal(f, f0)
    Jr, fr = f32_reference(p, y_t, P_t, True)
    for got, ref in ((Jt, Jr), (f, fr)):
        share, err = _f32_err(got, ref)
        assert share >= 0.995 and err < 2e-5, (share, err)


def test_fused_f32_launcher_refuses_cpu_and_f64(card):
    """The K3 launcher takes float32 CUDA tensors only."""
    _, p = flagship()
    fj = F32Jacobian(p, device=card)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.fused_f32(fj, torch.zeros((fj.N, 4)), torch.ones((1, 4)))
    with pytest.raises(ValueError, match='float32'):
        kernels.fused_f32(fj, torch.zeros((fj.N, 4), dtype=torch.float64,
                                          device=card),
                          torch.ones((1, 4), dtype=torch.float64,
                                     device=card))


def test_operators_opcheck_on_card(card):
    """The registered operators K1, K2 and K4 under
    ``torch.library.opcheck`` on the card (their launches beside their
    fake implementations: schema, shapes, dtypes, strides, dynamic
    batch) on the 9/24 all-features synth, a ragged B."""
    mech, p = packed_from_text(synthetic_mechanism(9, 24, seed=7))
    y, _, P = random_states(mech, 333, seed=3)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(P[None].copy(), device=card)
    sj = SparseJacobian(p, device=card)
    dj = DenseJacobian(p, device=card)
    ops = torch.ops.pyjac_tpu_torch
    torch.library.opcheck(ops.stage_a.default,
                          (*kernels.stage_a_inputs(sj), y_t, P_t))
    a = sj.stage_a(y_t, P_t)
    torch.library.opcheck(ops.stage_b.default,
                          (*kernels.stage_b_inputs(sj), a['src'], a['post']))
    torch.library.opcheck(ops.dense_fused.default,
                          (*kernels.dense_inputs(dj, torch.float64), y_t,
                           P_t))


@pytest.mark.parametrize('B', [1, 333])
def test_library_round_trip_on_card(card, tmp_path, B):
    """``libgen`` exported for the card and loaded back: the kernel
    entries launch K1 + K2 and K4 once a call through the operators and
    equal the live modules bit for bit; the plain dydt equals the live
    function's; one artifact serves both batch sizes."""
    from pyjac_tpu_torch.libgen import generate_library, load_library
    from pyjac_tpu_torch.ops.dydt import dydt
    mech, p = packed_from_text(synthetic_mechanism(9, 24, seed=7))
    generate_library(p, str(tmp_path), ('jacobian_dd_sparse', 'jacobian_dd',
                                        'dydt'), device=card)
    lib = load_library(str(tmp_path))
    assert lib['manifest']['device'] == str(card)
    y, _, P = random_states(mech, B, seed=3)
    y_t = torch.as_tensor(y.T.copy(), device=card)
    P_t = torch.as_tensor(P[None].copy(), device=card)
    for name, mod, kern in (
            ('jacobian_dd_sparse', SparseJacobian(p, device=card),
             ('stage_a', 'stage_b')),
            ('jacobian_dd', DenseJacobian(p, device=card), ('dense_fused',))):
        kernels.reset_launches()
        got = lib[name](y_t, P_t)
        torch.cuda.synchronize(card)
        assert kernels.launches == {k: int(k in kern)
                                    for k in kernels.launches}
        for a, b in zip(got, mod.call_tr(y_t, P_t)):
            assert torch.equal(a, b)
    yb, Pb = y_t.T.contiguous(), P_t[0].contiguous()
    assert torch.equal(lib['dydt'](Pb, yb), dydt(p, 0.0, Pb, yb))
