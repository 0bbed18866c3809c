"""The port's stiff integrator (``pyjac_tpu_torch.integrate``) against the
JAX package's, on the CPU.

Both sides integrate the same numpy inputs: flagship PaSR states from
``tests/data/flagship_states.npz`` (the JAX package's own integrator
tests use h2o2, whose ``.cti`` is not in the repository).  The JAX side
runs its ``jacobian='xla'`` path, the one JAX runs on the CPU; the port
runs both ``jacobian='xla'`` (the plain f64 ``eval_jacobian``) and
``jacobian='dd'`` (``DenseJacobian``, whose plain version runs on the
CPU).  The flagship is parsed by the JAX package and carried over with
``packed_from_arrays``.

Readings (x86-64 CPU, float64): both methods and both port Jacobians
take exactly JAX's accepted and rejected steps and status on every state
(8 PaSR states over 1e-5 s: 10-11 steps; 4 states heated by 300 K:
199-212 steps with 6 rejections each under ROS23); endpoints
floored@1e-10 agree to 5e-15 - 8e-14.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.integrate import ignition_delay as jignition_delay
from pyjac_tpu.integrate import integrate as jintegrate
from pyjac_tpu.testers.synthetic import (plausible_mechanism,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import packed_from_arrays
from pyjac_tpu_torch.integrate import (FLOOR_ROWS, STATUS_BUDGET,
                                       STATUS_SUCCESS, ignition_delay,
                                       integrate, ladder, lu_factor,
                                       lu_solve)

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'

# flagship PaSR states that reject steps once heated by 300 K
HOT = [0, 3, 5, 7]

_CACHE = {}


def _mech(tmp_path_factory, name='flagship'):
    """(JAX packed, port packed from the JAX arrays)."""
    if name not in _CACHE:
        text = (plausible_mechanism(53, 325, seed=42) if name == 'flagship'
                else synthetic_mechanism(n_species=9, n_reactions=24, seed=7))
        path = tmp_path_factory.mktemp(name) / 'm.inp'
        path.write_text(text)
        jp = jpack(JMechanism.from_files(str(path)))
        fields = {k: getattr(jp, k) for k in jp.__dataclass_fields__
                  if k != 'mech'}
        _CACHE[name] = (jp, packed_from_arrays(
            fields, Mechanism.from_files(str(path))))
    return _CACHE[name]


def _states(idx=slice(0, 8), heat=0.0):
    d = np.load(DATA / 'flagship_states.npz')
    y, P = d['y'][idx].copy(), d['P'][idx].copy()
    y[:, 0] += heat
    return y, P


def _floored(a, b, floor=1e-10):
    """Endpoint metric: floored at ``floor`` of each state's largest
    entry."""
    a, b = np.asarray(a), np.asarray(b)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


def _same_run(res, jres):
    """Equal accepted / rejected counts and status per state, endpoints
    within 1e-9 floored@1e-10."""
    for k in ('steps', 'rejected', 'status'):
        assert np.array_equal(getattr(res, k).numpy(),
                              np.asarray(getattr(jres, k))), k
    assert np.array_equal(res.t.numpy(), np.asarray(jres.t))
    assert _floored(res.y.numpy(), jres.y) <= 1e-9


@pytest.fixture(scope='module')
def jax_runs(tmp_path_factory):
    """JAX integrate results, computed once per (case, method)."""
    jp, _ = _mech(tmp_path_factory)
    cases = {'pasr': _states(), 'hot': _states(HOT, 300.0)}
    out = {}

    def run(case, method):
        if (case, method) not in out:
            y, P = cases[case]
            out[case, method] = jintegrate(jp, jnp.asarray(y), jnp.asarray(P),
                                           1e-5, method=method)
        return out[case, method]
    return run


@pytest.mark.parametrize('method', ['ros23', 'rodas3'])
@pytest.mark.parametrize('jacobian', ['xla', 'dd'])
def test_pasr_states_match_jax(tmp_path_factory, jax_runs, method, jacobian):
    """8 flagship PaSR states over 1e-5 s: the same steps, rejections and
    status per state as JAX's integrate, endpoints <= 1e-9 floored."""
    _, p = _mech(tmp_path_factory)
    y, P = _states()
    res = integrate(p, y, P, 1e-5, jacobian=jacobian, method=method,
                    device='cpu')
    assert bool((res.status == STATUS_SUCCESS).all())
    assert res.iterations == int(res.steps.max() + res.rejected.max())
    _same_run(res, jax_runs('pasr', method))


@pytest.mark.parametrize('jacobian', ['xla', 'dd'])
def test_rejection_path_matches_jax(tmp_path_factory, jax_runs, jacobian):
    """4 PaSR states heated by 300 K over 1e-5 s under ROS23: ~200 steps
    with 6 rejected steps each, equal to JAX's per state."""
    _, p = _mech(tmp_path_factory)
    y, P = _states(HOT, 300.0)
    res = integrate(p, y, P, 1e-5, jacobian=jacobian, device='cpu')
    assert bool((res.rejected == 6).all())
    _same_run(res, jax_runs('hot', 'ros23'))


@pytest.mark.parametrize('method', ['ros23', 'rodas3'])
@pytest.mark.parametrize('jacobian', ['xla', 'dd'])
def test_cpu_takes_no_dydt_kernel(tmp_path_factory, jax_runs, method,
                                  jacobian):
    """On the CPU every f is the plain ``ops/dydt.py``: under a profiler
    ``integrate.dydt_kernel`` reads 0, no kernel launches or builds, each
    iteration holds 3 dy/dt spans, and the results are JAX's."""
    from torch.profiler import ProfilerActivity, profile
    from pyjac_tpu_torch import profiling
    from pyjac_tpu_torch.ops import kernels
    _, p = _mech(tmp_path_factory)
    y, P = _states()
    before = dict(kernels.launches)
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = integrate(p, y, P, 1e-5, jacobian=jacobian, method=method,
                        device='cpu')
    assert profiling.counters.get('integrate.dydt_kernel', 0) == 0
    profiling.counters.clear()
    assert kernels.launches == before and kernels._lib is None
    spans = sum(e.name == 'pyjac.integrate.dydt' for e in prof.events())
    assert spans == 3 * res.iterations
    _same_run(res, jax_runs('pasr', method))


def test_status_codes_and_per_state_budget(tmp_path_factory):
    """``max_steps`` is a per-state attempt budget: 3 attempts over 1e-3 s
    leave every state at STATUS_BUDGET with at most 3 attempts."""
    _, p = _mech(tmp_path_factory)
    y, P = _states(slice(0, 4), 300.0)
    res = integrate(p, y, P, 1e-3, max_steps=3, device='cpu')
    assert not bool(res.success.any())
    assert bool((res.status == STATUS_BUDGET).all())
    assert int((res.steps + res.rejected).max()) <= 3


def test_trivial_interval(tmp_path_factory):
    """A near-zero interval: success at once, state unchanged."""
    _, p = _mech(tmp_path_factory)
    y, P = _states(slice(0, 1))
    res = integrate(p, y, P, 1e-12, device='cpu')
    assert bool(res.success.all())
    np.testing.assert_allclose(res.y.numpy(), y, rtol=1e-6, atol=1e-12)


def test_mixed_horizons(tmp_path_factory):
    """Per-state t_end: each state stops at its own horizon, where it
    ends as if integrated alone."""
    _, p = _mech(tmp_path_factory)
    y, P = _states(slice(0, 1), 300.0)
    y, P = np.repeat(y, 3, 0), np.repeat(P, 3)
    t_end = np.array([1e-9, 1e-8, 1e-7])
    res = integrate(p, y, P, t_end, rtol=1e-7, device='cpu')
    assert bool(res.success.all())
    np.testing.assert_allclose(res.t.numpy(), t_end, rtol=1e-12)
    for i in range(3):
        alone = integrate(p, y[i:i + 1], P[i:i + 1], t_end[i], rtol=1e-7,
                          device='cpu')
        assert int(alone.steps[0]) == int(res.steps[i])
        assert _floored(res.y[i:i + 1].numpy(), alone.y.numpy()) < 1e-12
    assert _floored(res.y[:1].numpy(), res.y[2:].numpy()) > 1e-6


@pytest.mark.parametrize('method', ['ros23', 'rodas3'])
def test_working_set_keeps_each_state_alone(tmp_path_factory, method):
    """384 flagship PaSR states, every eighth heated by 300 K, from a
    first step of 1e-9 s to horizons spread over 1e-10 - 1e-4 s (and 0
    for 48, so the loop compacts before its first iteration, while its
    states are the caller's) with a budget of 20 attempts: the active
    count falls through the ladder's sizes (384, 336, 288, 256), the
    loop re-compacts at least twice, steps are rejected, and the longest
    horizons end in STATUS_BUDGET.  Each state takes the steps,
    rejections and status it takes in JAX's integrate of the same batch
    and its endpoint lies within 1e-9 floored of JAX's; it ends at
    JAX's t where it reached t_end, and within 1e-9 of it where its
    budget ran out (a sum of adapted steps, which the two sides round
    apart by up to ~4e-10 with one size or many).  Every twelfth state
    takes the steps, rejections and status it takes integrated alone,
    its endpoint within 1e-9 floored (the plain versions' BLAS products
    sum in an order that depends on the batch size).  The caller's
    states are left as they were."""
    from torch.profiler import ProfilerActivity, profile
    from pyjac_tpu_torch import profiling
    jp, p = _mech(tmp_path_factory)
    B = 384
    y, P = _states(slice(0, B))
    y[::8, 0] += 300.0
    t_end = np.geomspace(1e-10, 1e-4, B)[
        np.random.default_rng(0).permutation(B)]
    t_end[1::8] = 0.0
    kw = dict(rtol=1e-6, atol=1e-10, max_steps=20, first_step=1e-9,
              method=method)
    y_in = torch.as_tensor(y)
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = integrate(p, y_in, P, t_end, device='cpu', **kw)
    compactions = profiling.counters.get('integrate.compactions', 0)
    profiling.counters.clear()
    assert compactions >= 2
    assert np.array_equal(y_in.numpy(), y)
    status = res.status.numpy()
    assert (status == STATUS_BUDGET).any() and (status == STATUS_SUCCESS).any()
    assert int(res.rejected.sum()) > 0
    jres = jintegrate(jp, jnp.asarray(y), jnp.asarray(P), jnp.asarray(t_end),
                      **kw)
    for k in ('steps', 'rejected', 'status'):
        assert np.array_equal(getattr(res, k).numpy(),
                              np.asarray(getattr(jres, k))), k
    assert _floored(res.y.numpy(), jres.y) <= 1e-9
    t, jt = res.t.numpy(), np.asarray(jres.t)
    done = status == STATUS_SUCCESS
    assert np.array_equal(t[done], jt[done])
    assert np.allclose(t[~done], jt[~done], rtol=1e-9, atol=0.0)
    for i in range(0, B, 12):
        alone = integrate(p, y[i:i + 1], P[i:i + 1], t_end[i], device='cpu',
                          **kw)
        for k in ('steps', 'rejected', 'status'):
            assert int(getattr(alone, k)[0]) == int(getattr(res, k)[i]), (i, k)
        assert _floored(res.y[i:i + 1].numpy(), alone.y.numpy()) <= 1e-9


def test_ladder_is_a_function_of_the_batch():
    """The working-set sizes: B alone at or below the floor; else B, the
    multiples of ceil(B / 8) below it and their step's halvings, down to
    the floor, so padding is at most an eighth of B above B / 8."""
    assert ladder(1) == (1,) and ladder(100) == (100,)
    assert ladder(FLOOR_ROWS) == (FLOOR_ROWS,)
    assert ladder(384) == (384, 336, 288, 256)
    assert ladder(1000) == (1000, 875, 750, 625, 500, 375, 256)
    big = ladder(32768)
    assert big[:8] == tuple(4096 * k for k in range(8, 0, -1))
    assert big[8:] == (2048, 1024, 512, 256)
    for B in (257, 300, 1029, 4032, 4099, 131072):
        sizes = ladder(B)
        assert sizes[0] == B and sizes[-1] == FLOOR_ROWS
        assert list(sizes) == sorted(set(sizes), reverse=True)
        assert len(sizes) <= 17
        for n in range(max(B // 8, FLOOR_ROWS), B + 1, max(1, B // 97)):
            assert min(s for s in sizes if s >= n) - n <= -(-B // 8)


def test_unknown_options_raise(tmp_path_factory):
    _, p = _mech(tmp_path_factory)
    y, P = _states(slice(0, 1))
    with pytest.raises(ValueError, match='unknown method'):
        integrate(p, y, P, 1e-6, method='bdf', device='cpu')
    with pytest.raises(ValueError, match='unknown jacobian'):
        integrate(p, y, P, 1e-6, jacobian='fd', device='cpu')


def test_dd_has_no_fallback(tmp_path_factory):
    """``jacobian='dd'`` on a mechanism ``DenseJacobian`` refuses (a
    sign-flipping PLOG table) raises instead of switching to XLA."""
    _, p = _mech(tmp_path_factory, 'synth')
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    bad = dataclasses.replace(p, plog_sign=sign)
    y = np.concatenate([[1200.0], np.full(p.n_species - 1, 0.1)])[None]
    with pytest.raises(NotImplementedError, match='PLOG'):
        integrate(bad, y, [101325.0], 1e-6, jacobian='dd', device='cpu')


def test_default_device_is_the_card(tmp_path_factory):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, p = _mech(tmp_path_factory)
    y, P = _states(slice(0, 1))
    with pytest.raises(RuntimeError, match='CUDA'):
        integrate(p, y, P, 1e-6)


def test_ignition_delay_matches_jax(tmp_path_factory):
    """The bisection on 2 heated states (T rises ~2 K within 1e-8 s) with
    a 1 K threshold and ``n_points=4`` gives JAX's delays."""
    jp, p = _mech(tmp_path_factory)
    y, P = _states([0, 3], 300.0)
    got = ignition_delay(p, y, P, 1e-8, threshold=1.0, n_points=4,
                         device='cpu')
    ref = jignition_delay(jp, jnp.asarray(y), jnp.asarray(P), 1e-8,
                          threshold=1.0, n_points=4)
    assert got.shape == (2,) and (got > 0).all() and (got < 1e-8).all()
    assert np.array_equal(got, np.asarray(ref))


def test_lu_solve_matches_numpy():
    """The iteration-matrix factor and solve against numpy's LAPACK
    solve, a zero on the diagonal (pivoting), and a singular matrix,
    whose solve is not finite and whose factor is flagged.  Each matrix
    A goes in as W = I - s J with s = 1 and J = I - A (exact for the
    2 x 2 matrices, within rounding for the others)."""
    def factor(A):
        A = torch.as_tensor(A)
        eye = torch.eye(A.shape[-1], dtype=A.dtype)
        return lu_factor(eye - A, torch.ones(A.shape[0], dtype=A.dtype))

    rng = np.random.default_rng(7)
    for n in (3, 10, 53):
        A = rng.standard_normal((8, n, n)) + n * np.eye(n)
        b = rng.standard_normal((8, n))
        fac = factor(A)
        assert bool(fac[2].all())
        x = lu_solve(fac, torch.as_tensor(b)).numpy()
        x_ref = np.linalg.solve(A, b[..., None])[..., 0]
        assert np.max(np.abs(x - x_ref)) < 1e-12
    A = torch.tensor([[[0.0, 1.0], [1.0, 0.0]]], dtype=torch.float64)
    x = lu_solve(factor(A), torch.tensor([[2.0, 3.0]],
                                         dtype=torch.float64))
    np.testing.assert_allclose(x.numpy(), [[3.0, 2.0]], atol=1e-14)
    S = torch.tensor([[[1.0, 2.0], [2.0, 4.0]]], dtype=torch.float64)
    fac = factor(S)
    assert not bool(fac[2].any())
    x = lu_solve(fac, torch.tensor([[1.0, 1.0]], dtype=torch.float64))
    assert not bool(torch.isfinite(x).all())
