"""The port's dense fused Jacobian (``DenseJacobian``) against the JAX
package, on the CPU.

On CPU tensors ``DenseJacobian`` runs ``dense_reference``, the plain
version of its CUDA kernel K4.  These tests hold it against the JAX
package's f64 ``jacobian_and_dydt``, its dense dd math
``jacobian_dd_xla`` (the CPU-checkable math of ``PallasDDJacobian``,
called eagerly and never jitted: a barriered dd graph takes minutes to
compile on XLA:CPU), and both reference-C goldens; they hold K4's
column tables against the plain dense columns, and ``supports`` against
the JAX package's.  The mechanisms are parsed by the JAX package and
carried over with ``packed_from_arrays``, so both sides compute from the
same numbers.  K4 itself runs only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import dataclasses
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
from pyjac_tpu_torch.core.constants import RU
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import packed_from_arrays
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.jacobian_big import (finish, parts_reference,
                                              state_thermo)
from pyjac_tpu_torch.ops.jacobian_dense import (DenseJacobian,
                                                dense_reference,
                                                operand_csr, supports)
from pyjac_tpu_torch.ops.jacobian_sparse import post_col_reference

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'

MECHS = {
    'flagship': lambda: plausible_mechanism(53, 325, seed=42),
    'synth': lambda: synthetic_mechanism(n_species=9, n_reactions=24,
                                         seed=7),
    'small': lambda: synthetic_mechanism(n_species=6, n_reactions=10,
                                         seed=7, gri_mix=True),
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


def _states(jm, p, name, B=64):
    if name == 'flagship':
        d = np.load(DATA / 'flagship_states.npz')
        return d['y'][:B], d['P'][:B]
    y, _, P = random_states(jm, B, seed=3)
    return y, P


def _density(p, y, P):
    """Each state's own density (CONV takes density)."""
    Yf = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)], 1)
    return P / (RU * y[:, 0] * (Yf * p.inv_mw).sum(1))


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


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('conp', [True, False])
def test_matches_jax_f64(tmp_path_factory, name, conp):
    """64 states (flagship PaSR; the all-features synth's random draw)
    against the JAX f64 ``jacobian_and_dydt``: J floored@1e-10 < 1e-10,
    dy/dt norm-relative < 1e-7."""
    jm, jp, p = _mech(tmp_path_factory, name)
    y, P = _states(jm, p, name)
    param = P if conp else _density(p, y, P)
    J, f = DenseJacobian(p, conp=conp, device='cpu')(y, param)
    jJ, jf = jjacobian_and_dydt(jp, 0.0, jnp.asarray(param), jnp.asarray(y),
                                conp=conp)
    assert J.shape == (64, p.n_species, p.n_species)
    assert J.dtype == f.dtype == torch.float64
    assert _floored(J.numpy(), np.asarray(jJ), 1e-10) < 1e-10
    assert _norm_rel(f.numpy(), np.asarray(jf)) < 1e-7


def test_matches_jax_dense_dd_math(tmp_path_factory):
    """The 6/10 synth at B = 8 against ``jacobian_dd_xla`` (the JAX dense
    dd kernel's math on the CPU, eager): J floored@1e-10 < 1e-9 and dy/dt
    norm-relative < 1e-9 (the dd side carries ~2^-48 pairs)."""
    from pyjac_tpu.ops.pallas_dd import jacobian_dd_xla
    jm, jp, p = _mech(tmp_path_factory, 'small')
    y, P = _states(jm, p, 'small', B=8)
    Jdd, fdd = jacobian_dd_xla(jp, P, y)
    J, f = DenseJacobian(p, device='cpu')(y, P)
    assert _floored(J.numpy(), np.asarray(Jdd), 1e-10) < 1e-9
    assert _norm_rel(f.numpy(), np.asarray(fdd)) < 1e-9


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_golden(tmp_path_factory, name):
    """Both reference-C goldens (J in the reference's column-major
    layout): the flagship at ``test_golden_parity``'s metric (J
    floored@1e-10 < 1e-8, dy/dt norm-relative < 1e-7), the all-features
    synth at ``TestAllFeaturesGolden``'s (J floored@1e-9 < 1e-8, dy/dt
    floored@1e-9 < 1e-10)."""
    _, _, p = _mech(tmp_path_factory, name)
    g = np.load(DATA / ('golden_%s_refc.npz' % name))
    n = len(g['T'])
    J, f = DenseJacobian(p, device='cpu')(g['y'], g['P'])
    Jl = J.numpy().transpose(0, 2, 1).reshape(n, -1)
    if name == 'flagship':
        assert _floored(Jl, g['ref_jac'], 1e-10) < 1e-8
        assert _norm_rel(f.numpy(), g['ref_dydt']) < 1e-7
    else:
        assert _floored(Jl, g['ref_jac'], 1e-9) < 1e-8
        assert _floored(f.numpy(), g['ref_dydt'], 1e-9) < 1e-10


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('conp', [True, False])
def test_operand_tables_give_the_dense_columns(tmp_path_factory, name,
                                               conp):
    """K4's column tables (``operand_csr``): contracting the role array
    row by row as the kernel does, then ``_post_col``, gives the plain
    dense columns to roundoff (floored@1e-10 < 1e-12 of J)."""
    jm, _, p = _mech(tmp_path_factory, name)
    y, P = _states(jm, p, name, B=16)
    param = P if conp else _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy())
    P_t = torch.as_tensor(np.asarray(param)[None].copy())
    st = state_thermo(p, y_t, P_t, conp)
    roles = parts_reference(p, st, conp)
    post = finish(p, st, roles, conp)['post']
    ptr, row, coef = operand_csr(p)
    N, J = p.n_species, p.n_species - 1
    flat = roles.reshape(-1, roles.shape[-1])
    terms = torch.as_tensor(coef)[:, None] * flat[torch.as_tensor(
        row.astype(np.int64))]
    seg = np.repeat(np.arange(J * N), np.diff(ptr))
    dcol = torch.zeros((J * N, flat.shape[1]), dtype=torch.float64)
    dcol.index_add_(0, torch.as_tensor(seg), terms)
    cols = post_col_reference(dcol.view(J, N, -1), torch.arange(J),
                              torch.as_tensor(p.inv_mw), post, conp)
    Jt, _ = dense_reference(p, y_t, P_t, conp)
    assert _floored(cols.permute(2, 0, 1).numpy(),
                    Jt[1:].permute(2, 0, 1).numpy(), 1e-10) < 1e-12


def test_supports_matches_jax(tmp_path_factory):
    """``supports`` agrees with the JAX package's on the flagship, the
    all-features synth and a sign-flipping PLOG table, which it refuses
    and ``DenseJacobian`` raises on."""
    from pyjac_tpu.ops.pallas_dd import supports as jsupports
    for name in ('flagship', 'synth'):
        _, jp, p = _mech(tmp_path_factory, name)
        assert supports(p) == jsupports(jp) is True
    _, jp, p = _mech(tmp_path_factory, 'synth')
    assert p.has_plog
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    jbad = dataclasses.replace(jp, plog_sign=sign)
    bad = dataclasses.replace(p, plog_sign=sign)
    assert supports(bad) == jsupports(jbad) is False
    with pytest.raises(NotImplementedError, match='PLOG'):
        DenseJacobian(bad, device='cpu')


def test_rejects_wrong_state_width(tmp_path_factory):
    """A (B, N') batch of another width raises ValueError up front
    (``test_pallas_dd.py::test_kernel_rejects_wrong_state_width``)."""
    _, _, p = _mech(tmp_path_factory, 'small')
    dj = DenseJacobian(p, device='cpu')
    with pytest.raises(ValueError, match='states must be'):
        dj(np.ones((8, p.n_species + 1)), np.full(8, 101325.0))
    with pytest.raises(ValueError, match='states must be'):
        dj(np.ones(p.n_species), 101325.0)


def test_default_device_is_the_card(tmp_path_factory):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, _, p = _mech(tmp_path_factory, 'small')
    with pytest.raises(RuntimeError, match='CUDA'):
        DenseJacobian(p)


def test_launcher_refuses_cpu_tensors(tmp_path_factory):
    """No fallback: the K4 launcher given CPU tensors raises, builds
    nothing and counts no launch."""
    _, _, p = _mech(tmp_path_factory, 'small')
    dj = DenseJacobian(p, device='cpu')
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dense_fused(dj, torch.zeros((dj.N, 4), dtype=torch.float64),
                            torch.ones((1, 4), dtype=torch.float64))
    assert kernels.launches == before and kernels._lib is None


def test_dydt_launcher_refuses_cpu_tensors(tmp_path_factory):
    """No fallback either: the dy/dt kernel's launcher given CPU tensors
    raises, builds nothing and counts no launch."""
    _, _, p = _mech(tmp_path_factory, 'small')
    dj = DenseJacobian(p, device='cpu')
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dydt(dj, torch.zeros((dj.N, 4), dtype=torch.float64),
                     torch.ones((1, 4), dtype=torch.float64))
    assert kernels.launches == before and kernels._lib is None


# ---------------------------------------------------------------------------
# K4's tile planner (kernels.tile_plan): what the card's launch asks
# for, computed on the host
# ---------------------------------------------------------------------------

# the classes K4 is held at on the card: (N, R, seed) of the port's
# plausible_mechanism
PLAN_MECHS = {'flagship': (53, 325, 42), 'usc': (111, 784, 5),
              '654': (654, 2716, 5)}


def _plan_packed(name):
    from pyjac_tpu_torch.testers.synthetic import (
        packed_from_text, plausible_mechanism as port_plausible)
    if ('plan', name) not in _CACHE:
        N, R, seed = PLAN_MECHS[name]
        _CACHE['plan', name] = packed_from_text(port_plausible(N, R,
                                                               seed=seed))[1]
    return _CACHE['plan', name]


@pytest.mark.parametrize('name, tile, placement', [
    ('flagship', 8, 'shared'), ('usc', 3, 'shared'), ('654', 1, 'global')])
def test_tile_plan(name, tile, placement):
    """K4 keeps a tile of states' rows on the SM: in shared memory where a
    state's rows fit one block's 227 KB, as many states as fit, rounded
    down to whole 32 B sectors of J (4 states in f64) where a sector's
    states fit (the flagship: 8 of 28.6 KB; USC-II: 3 of 67 KB), one
    block a tile; the 654 class (258 KB a state) in one global slice per
    SM, sized to fit the L2 together, the 132 blocks looping over the
    tiles."""
    dj = DenseJacobian(_plan_packed(name), device='cpu')
    B = 32768
    plan = kernels.tile_plan(dj, torch.float64, B)
    dims = kernels._kinetics_dims(dj)
    rows = kernels.dense_tile_rows(*dims[:4], dims[10])
    assert (plan['tile'], plan['placement'], plan['rows']) == (
        tile, placement, rows)
    assert plan['smem_bytes'] <= kernels.SMEM_MAX
    if placement == 'shared':
        assert plan['smem_bytes'] == rows * tile * 8
        assert (tile + (4 if tile >= 4 else 1)) * rows * 8 > kernels.SMEM_MAX
        assert plan['grid'] == -(-B // tile) and plan['scratch_elems'] == 0
    else:
        assert rows * 8 > kernels.SMEM_MAX and plan['smem_bytes'] == 0
        # one slice of tile x rows values per block, all of them within
        # the L2 budget
        assert plan['grid'] == 132
        assert plan['scratch_elems'] == plan['grid'] * tile * rows
        assert plan['scratch_elems'] * 8 <= kernels.L2_SLICES


def _dydt_layout(N, R):
    """``dydt_tile_layout`` of ``csrc/state_tile.cuh``, field by field:
    {row block: (first row, rows)}."""
    y, n_y = 0, N + 1
    scal = y + n_y
    st = scal + 4
    q = st + 5 + 3 * N
    cp = q + R
    h = cp + N
    return {'y': (y, n_y), 'scal': (scal, 4), 'st': (st, 5 + 3 * N),
            'q': (q, R), 'cp': (cp, N), 'h': (h, N), 'dcp': (h + N, N)}


@pytest.mark.parametrize('name, tile, fit', [('flagship', 16, 41),
                                             ('usc', 16, 18), ('654', 3, 3)])
def test_dydt_tile_plan(name, tile, fit):
    """The dy/dt kernel's tile: its rows a state (``dydt_tile_rows``,
    the C layout mirrored here: y and P, the state scalars, the
    state/thermo rows, which later hold omega, dT/dt's N terms and the
    closure's 2 sums, q, then cp, h and dcp) and the planner's states a
    tile, as many as fit one block's shared memory up to
    ``DYDT_TILE`` (16), rounded down to whole 32 B sectors where a
    sector's states fit: 16 flagship states of the 41 that fit (K4: 8),
    16 at USC-II (K4: 3), 3 at the 654 class (K4: one, in a global
    slice)."""
    dj = DenseJacobian(_plan_packed(name), device='cpu')
    N, R = dj.N, dj.R
    L = _dydt_layout(N, R)
    blocks = sorted(L.values())
    assert all(a + n == b for (a, n), (b, _) in zip(blocks, blocks[1:]))
    assert L['st'][1] >= 2 * N + 2
    rows = sum(n for _, n in blocks)
    assert kernels.dydt_tile_rows(N, R) == rows
    B = 32768
    plan = kernels.tile_plan(dj, torch.float64, B, kernel='dydt')
    assert (plan['tile'], plan['placement'], plan['rows']) == (
        tile, 'shared', rows)
    assert plan['smem_bytes'] == rows * tile * 8 <= kernels.SMEM_MAX
    assert kernels.SMEM_MAX // (rows * 8) == fit
    assert tile == min(fit, kernels.DYDT_TILE) // (4 if fit >= 4 else 1) \
        * (4 if fit >= 4 else 1)
    assert plan['grid'] == -(-B // tile) and plan['scratch_elems'] == 0
    g = kernels.tile_plan(dj, torch.float64, B, kernel='dydt',
                          placement='global')
    assert (g['placement'], g['grid'], g['rows']) == ('global', 132, rows)
    assert g['scratch_elems'] == 132 * g['tile'] * rows


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_tile_rows_hold_the_plain_pieces(tmp_path_factory, name):
    """A state's tile rows (``dense_tile_rows``; the kernel's
    ``tile_layout`` checks the count at launch) are the plain version's
    per-state arrays: y and P, 4 state scalars, the state/thermo rows
    (which later hold omega, domega and the closure's 2 sums), the role
    array less its xi_q rows where no reaction has species-specific
    pdep, the post rows, and h and dcp."""
    jm, _, p = _mech(tmp_path_factory, name)
    y, P = _states(jm, p, name, B=4)
    y_t = torch.as_tensor(y.T.copy())
    P_t = torch.as_tensor(np.asarray(P)[None].copy())
    st = state_thermo(p, y_t, P_t, True)
    roles = parts_reference(p, st, True)
    post = finish(p, st, roles, True)['post']
    N, R = p.n_species, p.n_reactions
    spec = bool(p.has_specific_pdep_sp)
    assert st['rows'].shape[0] >= 2 * N + 2 and 4 * R >= N
    want = (N + 1) + 4 + st['rows'].shape[0] + \
        (roles.shape[0] - (not spec)) * R + post.shape[0] + 2 * N
    assert kernels.dense_tile_rows(N, R, p.reac_sp.shape[1],
                                   p.prod_sp.shape[1], spec) == want


def test_tile_plan_ragged_and_overrides():
    """A ragged batch takes one more tile; a tile / placement given
    overrides the planner's choice (7 states a tile; the global
    placement: 132 slices of 4 states); a tile that does not fit shared
    memory, no tile, and an unknown placement raise."""
    dj = DenseJacobian(_plan_packed('flagship'), device='cpu')
    plan = kernels.tile_plan(dj, torch.float64, 4099)
    assert (plan['tile'], plan['grid']) == (8, 513)
    seven = kernels.tile_plan(dj, torch.float64, 4099, tile=7)
    assert (seven['grid'], seven['smem_bytes']) == (586, 7 * 8 * plan['rows'])
    g = kernels.tile_plan(dj, torch.float64, 4099, placement='global')
    assert (g['tile'], g['placement'], g['grid']) == (4, 'global', 132)
    assert g['scratch_elems'] == 132 * 4 * g['rows']
    with pytest.raises(ValueError, match='shared memory'):
        kernels.tile_plan(dj, torch.float64, 4099, tile=9)
    with pytest.raises(ValueError, match='a tile holds'):
        kernels.tile_plan(dj, torch.float64, 4099, tile=0)
    with pytest.raises(ValueError, match='placement'):
        kernels.tile_plan(dj, torch.float64, 4099, placement='l2')
