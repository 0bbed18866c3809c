"""The port's float32 fused Jacobian (``F32Jacobian``) against the JAX
package, on the CPU.

On CPU tensors ``F32Jacobian`` runs ``f32_reference``, the plain version
of its CUDA kernel K3.  These tests hold it against the JAX package's
``PallasJacobian`` run as the JAX package's own tests run it on the CPU
(``interpret=True``, ``block_b=64``) and against the port's float64
``jacobian_and_dydt``, with the JAX package's f32 metric
(``tests/test_pallas_jacobian.py:52-59``): a finite share of at least
0.995, and max |diff| on the entries finite on both sides below 2e-5 of
the reference's scale.  The mechanisms are parsed by the JAX package and
carried over with ``packed_from_arrays``, so both sides compute from the
same numbers; the JAX interpret calls run once per module (a fixture).
K3 itself runs only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops.pallas_jacobian import PallasJacobian
from pyjac_tpu.ops.pallas_jacobian import supports as jsupports
from pyjac_tpu.testers.synthetic import (plausible_mechanism,
                                         random_states,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.constants import RU
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import packed_from_arrays
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.dydt import dydt
from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt, reaction_parts
from pyjac_tpu_torch.ops.jacobian_big import parts_tables
from pyjac_tpu_torch.ops.jacobian_dense import fused_tables
from pyjac_tpu_torch.ops.jacobian_f32 import (F32Jacobian, f32_reference,
                                              f32_tables, supports)

torch.set_num_threads(1)

MECHS = {
    'flagship': lambda: plausible_mechanism(53, 325, seed=42),
    'synth': lambda: synthetic_mechanism(n_species=9, n_reactions=24,
                                         seed=7),
}
# (mechanism, conp) cases the JAX kernel is run on, once per module
CASES = [('flagship', True), ('synth', True), ('synth', False)]
TOL = 2e-5
DATA = pathlib.Path(__file__).parent / 'data'


def _density(p, y, P):
    """Each state's own density (CONV takes density)."""
    Yf = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)], 1)
    return P / (RU * y[:, 0] * (Yf * p.inv_mw).sum(1))


@pytest.fixture(scope='module')
def mechs(tmp_path_factory):
    """name -> (JAX packed, port packed from the JAX arrays, 64 states,
    pressures): the flagship at T = 1500-2500 K (the f32 range, as the
    JAX tests draw it), the all-features synth's own draw."""
    out = {}
    for name, text in MECHS.items():
        path = tmp_path_factory.mktemp(name) / 'm.inp'
        path.write_text(text())
        jm = JMechanism.from_files(str(path))
        jp = jpack(jm)
        fields = {k: getattr(jp, k) for k in jp.__dataclass_fields__
                  if k != 'mech'}
        p = packed_from_arrays(fields, Mechanism.from_files(str(path)))
        if name == 'flagship':
            y, _, P = random_states(jm, 64, seed=1, T_range=(1500.0, 2500.0))
        else:
            y, _, P = random_states(jm, 64, seed=3)
        out[name] = (jp, p, y, P)
    return out


@pytest.fixture(scope='module')
def jax_runs(mechs):
    """(name, conp) -> (param, J, f) of JAX ``PallasJacobian`` in
    interpret mode (three calls for the whole module)."""
    out = {}
    for name, conp in CASES:
        jp, p, y, P = mechs[name]
        param = P if conp else _density(p, y, P)
        pj = PallasJacobian(jp, block_b=64, interpret=True, conp=conp)
        J, f = pj(y, param)
        out[name, conp] = (param, np.asarray(J), np.asarray(f))
    return out


def _f32_err(a, b):
    """(finite share, max |a - b| on entries finite in both / the
    largest |b| there)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    return fin.mean(), np.abs(a - b)[fin].max() / np.abs(b[fin]).max()


def _case_id(case):
    return '%s-%s' % (case[0], 'conp' if case[1] else 'conv')


@pytest.mark.parametrize('case', CASES, ids=_case_id)
def test_matches_jax_kernel(mechs, jax_runs, case):
    """``F32Jacobian(device='cpu')`` (batch-major) and ``f32_reference``
    (batch-minor) against JAX ``PallasJacobian(interpret=True)`` on the
    same states: J and f at 2e-5 of scale, finite share >= 0.995."""
    name, conp = case
    _, p, y, _ = mechs[name]
    param, jJ, jf = jax_runs[case]
    J, f = F32Jacobian(p, conp=conp, device='cpu')(y, param)
    assert J.dtype == f.dtype == torch.float32
    assert J.shape == (64, p.n_species, p.n_species)
    for got, ref in ((J, jJ), (f, jf)):
        share, err = _f32_err(got.numpy(), ref)
        assert share >= 0.995 and err < TOL, (share, err)
    y_t = torch.as_tensor(y.T.copy(), dtype=torch.float32)
    P_t = torch.as_tensor(np.asarray(param)[None].copy(), dtype=torch.float32)
    Jt, ft = f32_reference(p, y_t, P_t, conp)
    assert torch.equal(Jt.permute(2, 1, 0), J) and torch.equal(ft.T, f)


@pytest.mark.parametrize('case', CASES, ids=_case_id)
def test_matches_port_f64(mechs, case):
    """``f32_reference`` against the port's float64 ``jacobian_and_dydt``
    on the same states: J at 2e-5 of scale, f too under CONP and at 1e-3
    under CONV (the CONV energy sum cancels harder,
    ``test_pallas_jacobian.py:126``); finite share >= 0.995."""
    name, conp = case
    _, p, y, P = mechs[name]
    param = P if conp else _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy(), dtype=torch.float32)
    P_t = torch.as_tensor(np.asarray(param)[None].copy(), dtype=torch.float32)
    Jt, ft = f32_reference(p, y_t, P_t, conp)
    # the f64 side takes the same float32-rounded inputs
    J64, f64 = jacobian_and_dydt(p, 0.0, P_t[0].double(), y_t.T.double(),
                                 conp=conp)
    share, err = _f32_err(Jt.permute(2, 1, 0).numpy(), J64.numpy())
    assert share >= 0.995 and err < TOL, (share, err)
    share, err = _f32_err(ft.T.numpy(), f64.numpy())
    assert share >= 0.995 and err < (TOL if conp else 1e-3), (share, err)


def test_golden_dydt_loss_is_float32s_own(mechs):
    """On the 128 golden flagship states (PaSR states, near equilibrium)
    float32 dy/dt loses most of its digits on both sides: against the
    reference C, JAX ``PallasJacobian`` (interpret) reads 7.0e-2 of scale
    and the port's ``f32_reference`` 9.0e-2 (the K3 kernel read 8.9e-2 on
    an H100).  Both are float32 roundoff of the terms they sum: against
    float64 on the same float32-rounded states, each differs from it by
    less than 1e-4 of the summed magnitude of its row's terms,
    sum_r |nu_rn| |pm_r| (|Rf_r| + |Rr_r|) (JAX 4.6e-5, the port 1.5e-5:
    the exp of ln Kc and the rates round at ~1e2 float32 ulps), while
    those terms exceed the rows ~1e6-fold.  So the port's reading is held
    to at most twice JAX's (``chip_smoke.py`` phase 12 gates K3 the same
    way)."""
    jp, p, _, _ = mechs['flagship']
    g = np.load(DATA / 'golden_flagship_refc.npz')
    y, P, ref = g['y'], g['P'], g['ref_dydt']
    _, jf = PallasJacobian(jp, block_b=64, interpret=True)(y, P)
    jf = np.asarray(jf, np.float64)
    y_t = torch.as_tensor(y.T.copy(), dtype=torch.float32)
    P_t = torch.as_tensor(P[None].copy(), dtype=torch.float32)
    pf = f32_reference(p, y_t, P_t)[1].T.double().numpy()
    e_jax, e_port = _f32_err(jf, ref)[1], _f32_err(pf, ref)[1]
    assert 1e-2 < e_jax and e_port <= 2.0 * e_jax, (e_jax, e_port)
    # float64 on the same float32-rounded states, and the terms' magnitude
    y64, P64 = y_t.T.double(), P_t[0].double()
    f64 = dydt(p, 0.0, P64, y64).numpy()
    rp = reaction_parts(p, P64, y64)
    q_gross = (rp['pm'].abs() * (rp['Rf'].abs() + rp['Rr'].abs())).numpy()
    om = q_gross @ np.abs(np.asarray(p.nu_net, np.float64))
    mw, rho = np.asarray(p.mw), rp['rho'].numpy()
    gross = (om * mw / rho[:, None])[:, :-1]
    for f in (jf, pf):
        assert float((np.abs(f[:, 1:] - f64[:, 1:]) / gross).max()) < 1e-4
    assert float(np.median(gross / np.abs(f64[:, 1:]))) > 1e5


def test_supports_matches_jax(mechs):
    """``supports`` agrees with the JAX package's where its 50 MB VMEM
    clause does not bite (the flagship, the all-features synth) and on a
    sign-flipping PLOG table, which both refuse and ``F32Jacobian``
    raises on."""
    for name in ('flagship', 'synth'):
        jp, p, _, _ = mechs[name]
        assert supports(p) == jsupports(jp) is True
    jp, p, _, _ = mechs['synth']
    assert p.has_plog
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    bad = dataclasses.replace(p, plog_sign=sign)
    assert supports(bad) == jsupports(dataclasses.replace(
        jp, plog_sign=sign)) is False
    with pytest.raises(NotImplementedError, match='PLOG'):
        F32Jacobian(bad, device='cpu')


def test_kernel_tables_are_k4s_in_f32(mechs):
    """K3's table buffers are K4's (``parts_tables`` then
    ``fused_tables``, the C struct's order) with every float table cast
    to float32 and every index table int32."""
    _, p, _, _ = mechs['synth']
    m = F32Jacobian(p, device='cpu')
    want = [('kp_' + k, v) for k, v in parts_tables(p).items()] + \
        [('kf_' + k, v) for k, v in fused_tables(p).items()]
    assert list(f32_tables(p)) == [k for k, _ in want]
    for k, v in want:
        t = getattr(m, k)
        assert t.dtype == (torch.int32 if v.dtype == np.int32
                           else torch.float32), k
        assert np.array_equal(t.numpy(), v.astype(t.numpy().dtype)), k


def test_batch_major_layout(mechs):
    """``forward`` casts float64 input to float32 and returns J (B, N, N)
    with ``J[b, i, j] = d f_i / d y_j`` and f (B, N): the transposes of
    ``call_tr``'s [column, row, batch] and (N, B); a scalar pressure
    broadcasts."""
    _, p, y, P = mechs['synth']
    m = F32Jacobian(p, device='cpu')
    J, f = m(y[:5], 101325.0)
    y_t = torch.as_tensor(y[:5].T.copy(), dtype=torch.float32)
    P_t = torch.full((1, 5), 101325.0, dtype=torch.float32)
    Jt, ft = m.call_tr(y_t, P_t)
    assert J.shape == (5, p.n_species, p.n_species) and f.shape == (5, 9)
    assert torch.equal(J, Jt.permute(2, 1, 0)) and torch.equal(f, ft.T)
    # column 0 is the temperature column: J[b, :, 0] = Jt[0, :, b]
    assert torch.equal(J[:, :, 0], Jt[0].T)


def test_rejects_wrong_state_width(mechs):
    """A (B, N') batch of another width raises ValueError up front
    (``pallas_jacobian.check_state_width``)."""
    _, p, _, _ = mechs['synth']
    m = F32Jacobian(p, device='cpu')
    with pytest.raises(ValueError, match='state batch must be'):
        m(np.ones((8, p.n_species + 1)), np.full(8, 101325.0))
    with pytest.raises(ValueError, match='state batch must be'):
        m(np.ones(p.n_species), 101325.0)


def test_default_device_is_the_card(mechs):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, p, _, _ = mechs['synth']
    with pytest.raises(RuntimeError, match='CUDA'):
        F32Jacobian(p)


def test_launcher_refuses_cpu_tensors(mechs):
    """No fallback: the K3 launcher given CPU tensors raises, builds
    nothing and counts no launch."""
    _, p, _, _ = mechs['synth']
    m = F32Jacobian(p, device='cpu')
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.fused_f32(m, torch.zeros((m.N, 4)), torch.ones((1, 4)))
    assert kernels.launches == before and kernels._lib is None


@pytest.mark.parametrize('name, N, R, seed, tile', [
    ('flagship', 53, 325, 42, 16), ('usc', 111, 784, 5, 6),
    ('654', 654, 2716, 5, 1)])
def test_tile_plan(name, N, R, seed, tile):
    """K3's tiles (K4's planner at 4 bytes a value) stay in shared memory
    for all three classes: the flagship's 16 states (two 32 B sectors of
    J), USC-II's 6, the 654 class's one state of 129 KB; the bytes asked
    for never exceed a block's 227 KB, and the global placement's slices
    fit the L2 budget."""
    from pyjac_tpu_torch.testers.synthetic import (
        packed_from_text, plausible_mechanism as port_plausible)
    m = F32Jacobian(packed_from_text(port_plausible(N, R, seed=seed))[1],
                    device='cpu')
    B = 262144
    plan = kernels.tile_plan(m, torch.float32, B)
    rows = kernels.dense_tile_rows(N, R, 2, 2, False)
    assert (plan['tile'], plan['placement'], plan['rows']) == (
        tile, 'shared', rows)
    assert plan['smem_bytes'] == rows * tile * 4 <= kernels.SMEM_MAX
    assert plan['grid'] == -(-B // tile) and plan['scratch_elems'] == 0
    g = kernels.tile_plan(m, torch.float32, B, placement='global')
    assert g['grid'] == 132 and g['scratch_elems'] == 132 * g['tile'] * rows
    assert g['scratch_elems'] * 4 <= kernels.L2_SLICES
