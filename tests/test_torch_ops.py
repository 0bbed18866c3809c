"""The port's plain float64 ops (``pyjac_tpu_torch.ops``) against the JAX
package's, on the CPU.

The same numpy inputs go through both sides: the flagship reference-C
golden states (53 species / 325 reactions) and the all-features
synthetic golden (PLOG, Chebyshev, SRI, chemically activated,
fractional nu).  Port-vs-JAX agreement is held at 1e-12 norm-relative
per state (both sides are IEEE f64; only the contraction order
differs), except for net production rates and the dy/dt they feed:
the PaSR states sit near equilibrium, where net rates cancel to about
1e-9 of the gross fluxes (``tests/test_golden_parity.py:264-268``), so
a different summation order moves them by up to ~1e-9 of their norm
and they are held at 1e-9 (``NET_TOL``): on these CONP states the JAX
package's own ``dydt`` and ``jacobian_and_dydt`` already differ by
about 2e-10.  Port-vs-reference-C
agreement uses the tolerances of ``tests/test_golden_parity.py``.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops import dydt as jdydt
from pyjac_tpu.ops import jacobian as jjac
from pyjac_tpu.ops import rates as jrates
from pyjac_tpu.ops import thermo as jthermo
from pyjac_tpu.testers.synthetic import (plausible_mechanism,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import pack
from pyjac_tpu_torch.ops import dydt, jacobian, rates, thermo

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'
NET_TOL = 1e-9


def _norm_rel(a, b):
    """max over states of max|a-b| / max|b| (per-state norm-relative)."""
    a = np.asarray(a).reshape(len(b), -1)
    b = np.asarray(b).reshape(len(b), -1)
    return float((np.abs(a - b).max(-1) /
                  np.maximum(np.abs(b).max(-1), 1e-300)).max())


def _floored(a, b, floor):
    a = np.asarray(a).reshape(len(b), -1)
    b = np.asarray(b).reshape(len(b), -1)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


def _both(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(text)
    jm = JMechanism.from_files(str(path))
    m = Mechanism.from_files(str(path))
    return jpack(jm), pack(m)


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('flag')
    jp, p = _both(tmp, plausible_mechanism(53, 325, seed=42), 'flag.inp')
    g = np.load(DATA / 'golden_flagship_refc.npz')
    return jp, p, g


@pytest.fixture(scope='module')
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('synth')
    jp, p = _both(tmp, synthetic_mechanism(n_species=9, n_reactions=24,
                                           seed=7), 'synth.inp')
    g = np.load(DATA / 'golden_synth_refc.npz')
    return jp, p, g


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


@pytest.mark.parametrize('fn', ['eval_cp', 'eval_cv', 'eval_h', 'eval_u',
                                'eval_smh', 'eval_dsmh_dT', 'eval_dcp_dT'])
def test_thermo_matches_jax(flagship, fn):
    jp, p, g = flagship
    a = getattr(thermo, fn)(p, _t(g['T'])).numpy()
    b = np.asarray(getattr(jthermo, fn)(jp, jnp.asarray(g['T'])))
    assert _norm_rel(a, b) < 1e-12, fn


@pytest.mark.parametrize('case', ['flagship', 'synth'])
def test_rates_match_jax(flagship, synth, case):
    jp, p, g = flagship if case == 'flagship' else synth
    T, P, y = g['T'], g['P'], g['y']
    _, _, _, c = thermo.eval_conc(p, _t(T), _t(P), _t(y[:, 1:]))
    _, _, _, jc = jthermo.eval_conc(jp, jnp.asarray(T), jnp.asarray(P),
                                    jnp.asarray(y[:, 1:]))
    assert _norm_rel(c.numpy(), jc) < 1e-14
    fwd, rev = rates.eval_rxn_rates(p, _t(T), _t(P), c)
    jfwd, jrev = jrates.eval_rxn_rates(jp, jnp.asarray(T), jnp.asarray(P),
                                       jc)
    pm = rates.get_rxn_pres_mod(p, _t(T), _t(P), c)
    jpm = jrates.get_rxn_pres_mod(jp, jnp.asarray(T), jnp.asarray(P), jc)
    w = rates.eval_spec_rates(p, fwd, rev, pm)
    jw = jrates.eval_spec_rates(jp, jfwd, jrev, jpm)
    for name, a, b in [('fwd', fwd, jfwd), ('rev', rev, jrev),
                       ('pm', pm, jpm),
                       ('kc', rates.eval_kc(p, _t(T)),
                        jrates.eval_kc(jp, jnp.asarray(T)))]:
        assert _norm_rel(a.numpy(), b) < 1e-12, name
    assert _norm_rel(w.numpy(), jw) < NET_TOL


@pytest.mark.parametrize('conp', [True, False])
def test_dydt_matches_jax(flagship, conp):
    jp, p, g = flagship
    y, P = g['y'], g['P']
    a = dydt.dydt(p, 0.0, _t(P), _t(y), conp=conp).numpy()
    b = np.asarray(jdydt.dydt(jp, 0.0, jnp.asarray(P), jnp.asarray(y),
                              conp=conp))
    assert _norm_rel(a, b) < NET_TOL


@pytest.mark.parametrize('conp', [True, False])
def test_eval_jacobian_matches_jax(flagship, conp):
    jp, p, g = flagship
    y, P = g['y'], g['P']
    J, f = jacobian.jacobian_and_dydt(p, 0.0, _t(P), _t(y), conp=conp)
    jJ, jf = jjac.jacobian_and_dydt(jp, 0.0, jnp.asarray(P),
                                    jnp.asarray(y), conp=conp)
    assert _norm_rel(J.numpy(), jJ) < 1e-12
    assert _norm_rel(f.numpy(), jf) < NET_TOL


def test_flagship_golden(flagship):
    """The port's plain path against pyJac's generated C, with the
    metrics of ``test_golden_parity.TestFlagshipGolden.test_f64_parity``."""
    jp, p, g = flagship
    T, P, y = _t(g['T']), _t(g['P']), _t(g['y'])
    n = len(g['T'])
    _, _, _, c = thermo.eval_conc(p, T, P, y[:, 1:])
    fwd, rev, pm, _ = rates.rates_of_progress(p, T, P, c)
    w = rates.eval_spec_rates(p, fwd, rev, pm)
    J, f = jacobian.jacobian_and_dydt(p, 0.0, P, y)
    for name, a, b, tol in [
            ('conc', c, g['ref_conc'], 1e-12),
            ('fwd', fwd, g['ref_fwd'], 1e-12),
            ('rev', rates.compact_rev(p, rev), g['ref_rev'], 1e-12),
            ('pres_mod', rates.compact_pres_mod(p, pm), g['ref_pres_mod'],
             1e-12)]:
        assert _floored(a.numpy(), b, 1e-12) < tol, name
    Jl = J.numpy().transpose(0, 2, 1).reshape(n, -1)
    assert _floored(Jl, g['ref_jac'], 1e-10) < 1e-10
    assert _norm_rel(w.numpy(), g['ref_spec_rates']) < 1e-7
    assert _norm_rel(f.numpy(), g['ref_dydt']) < 1e-7


def test_synth_golden(synth):
    """All-features golden at the tolerances of
    ``test_golden_parity.TestAllFeaturesGolden.test_parity``."""
    jp, p, g = synth
    T, P, y = _t(g['T']), _t(g['P']), _t(g['y'])
    n = len(g['T'])
    _, _, _, c = thermo.eval_conc(p, T, P, y[:, 1:])
    fwd, rev, pm, _ = rates.rates_of_progress(p, T, P, c)
    w = rates.eval_spec_rates(p, fwd, rev, pm)
    f = dydt.dydt_conp(p, 0.0, P, y)
    J = jacobian.eval_jacobian(p, 0.0, P, y)
    for name, a, b, tol in [
            ('conc', c, g['ref_conc'], 1e-13),
            ('fwd', fwd, g['ref_fwd'], 1e-8),
            ('rev', rates.compact_rev(p, rev), g['ref_rev'], 1e-12),
            ('pm', rates.compact_pres_mod(p, pm), g['ref_pm'], 1e-13),
            ('sp', w, g['ref_sp'], 1e-10),
            ('dydt', f, g['ref_dydt'], 1e-10),
            ('jac', J.transpose(1, 2).reshape(n, -1), g['ref_jac'], 1e-8)]:
        assert _floored(a.numpy(), b, 1e-9) < tol, name


@pytest.mark.parametrize('conp', [True, False])
def test_jacobian_matches_jacfwd(synth, conp):
    """Closed form against ``torch.func.jacfwd`` of dydt on every
    category (CONV has no reference-C golden; AD is its oracle)."""
    _, p, g = synth
    y, P = _t(g['y'][:16]), _t(g['P'][:16])
    J = jacobian.eval_jacobian(p, 0.0, P, y, conp=conp)
    Jf = jacobian.jacobian_fwd(p, 0.0, P, y, conp=conp)
    assert _floored(J.numpy(), Jf.numpy(), 1e-10) < 1e-8
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(
        y.shape[-1]))
    jv = jacobian.jacobian_vector_product(p, 0.0, P[0], y[0], v, conp=conp)
    ref = J[0] @ v
    assert float((jv - ref).abs().max() / ref.abs().max()) < 1e-10
