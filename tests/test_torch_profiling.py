"""The port's ``profiling`` module against the JAX package's, on the CPU.

``cost_estimate`` is the JAX package's closed form, so it must give the
same numbers; ``speed_of_light`` reads this card's float64 peaks;
``timed`` and ``trace`` work off the card; ``roofline`` reproduces
the bound of every port kernel that ``PERF.md`` section 6 reports, from
the modules' tables and the outputs' shapes alone; and ``span`` /
``count`` record only under a profiler, nest the integrator's spans as
its loop runs, leave its results as they are and stay out of an
exported graph.
"""

import collections
import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.profiling import cost_estimate as jcost_estimate
from pyjac_tpu_torch import integrate, libgen, profiling
from pyjac_tpu_torch.integrate import ladder
from pyjac_tpu_torch.ops.jacobian_big import (BigJacobian, finish,
                                              source_stack, state_thermo)
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian
from pyjac_tpu_torch.ops.jacobian_sparse import (SparseJacobian,
                                                 stage_a_reference)
from pyjac_tpu_torch.testers.synthetic import (packed_from_text,
                                               plausible_mechanism,
                                               random_states,
                                               synthetic_mechanism,
                                               wide_mechanism)

torch.set_num_threads(1)

TEXTS = {'flagship': lambda: plausible_mechanism(53, 325, seed=42),
         'synth': lambda: synthetic_mechanism(9, 24, seed=7),
         'synth53': lambda: synthetic_mechanism(53, 325, seed=7),
         'usc': lambda: plausible_mechanism(111, 784, seed=5),
         '654': lambda: plausible_mechanism(654, 2716, seed=5),
         'wide': wide_mechanism}

_MECHS = {}


def _mech(name):
    """(mechanism, packed) of the port, built once per name."""
    if name not in _MECHS:
        _MECHS[name] = packed_from_text(TEXTS[name]())
    return _MECHS[name]


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('kernel', ['rates', 'dydt', 'jacobian'])
def test_cost_estimate_matches_jax(name, kernel, tmp_path):
    """The same closed form, field for field, in float64 and float32."""
    path = tmp_path / 'm.inp'
    path.write_text(TEXTS[name]())
    jp = jpack(JMechanism.from_files(str(path)))
    p = _mech(name)[1]
    for dtype_bytes in (8, 4):
        got = profiling.cost_estimate(p, kernel, dtype_bytes)
        want = jcost_estimate(jp, kernel, dtype_bytes)
        assert (got.flops_per_state, got.transcendentals_per_state,
                got.bytes_per_state) == (want.flops_per_state,
                                         want.transcendentals_per_state,
                                         want.bytes_per_state)
        assert got.arithmetic_intensity() == want.arithmetic_intensity()
    with pytest.raises(ValueError):
        profiling.cost_estimate(p, 'nope')


def test_speed_of_light_uses_h100_peaks():
    """The defaults are one H100 SXM in float64: HBM3 3.35 TB/s, FP64
    outside the tensor cores 34 TFLOP/s (FP32 67 TFLOP/s)."""
    assert (profiling.HBM_BYTES_S, profiling.F64_FLOP_S,
            profiling.F32_FLOP_S) == (3.35e12, 34e12, 67e12)
    p = _mech('flagship')[1]
    c = profiling.cost_estimate(p, 'jacobian', 8)
    sol = profiling.speed_of_light(p)
    assert sol['compute_bound_evals_per_sec'] == 34e12 / c.flops_per_state
    assert sol['memory_bound_evals_per_sec'] == 3.35e12 / c.bytes_per_state
    assert sol['arithmetic_intensity'] == c.arithmetic_intensity()


def test_timed_and_trace_on_the_cpu(tmp_path):
    """``timed`` returns the result and a positive time per call off the
    card; ``trace`` writes a Chrome trace of the block."""
    from pyjac_tpu_torch.ops.dydt import dydt
    mech, p = _mech('synth')
    y, _, P = random_states(mech, 16, seed=3)
    y, P = torch.as_tensor(y), torch.as_tensor(P)
    out, dt = profiling.timed(lambda a, b: dydt(p, 0.0, a, b), P, y, iters=2)
    assert dt > 0 and out.shape == (16, p.n_species)
    assert torch.equal(out, dydt(p, 0.0, P, y))
    with profiling.trace(str(tmp_path / 'tr')) as prof:
        dydt(p, 0.0, P, y)
    assert prof.key_averages()
    trace = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    assert trace['traceEvents']


# PERF.md section 6's bound column: (kernel, module, mechanism, B, ms)
PERF_BOUNDS = [
    ('stage_a', 'sparse', 'flagship', 131072, 0.761),
    ('stage_a', 'sparse', 'synth53', 131072, 0.967),
    ('stage_a', 'sparse', 'usc', 32768, 0.447),
    ('stage_b', 'sparse', 'flagship', 131072, 1.573),
    ('stage_b_x', 'unfused', 'flagship', 131072, 1.874),
    ('fused_f32', 'f32', 'flagship', 262144, 0.913),
    ('dense_fused', 'dense', 'flagship', 32768, 0.228),
    ('big_parts', 'big', '654', 1024, 0.071),
    ('big_cols_sparse', 'big', '654', 1024, 1.118),
    ('big_cols_dense', 'big_dense', '654', 512, 0.552),
    # the wide mechanism's rows (phase 18, B = 4099)
    ('stage_a', 'sparse', 'wide', 4099, 0.005),
    ('stage_b', 'sparse', 'wide', 4099, 0.008),
    ('stage_b_x', 'unfused', 'wide', 4099, 0.007),
    ('fused_f32', 'f32', 'wide', 4099, 0.002),
    ('dense_fused', 'dense', 'wide', 4099, 0.005),
    ('big_parts', 'big', 'wide', 4099, 0.004),
    ('big_cols_sparse', 'big', 'wide', 4099, 0.007),
    ('big_cols_dense', 'big_dense', 'wide', 4099, 0.008),
]

MODULES = {
    'sparse': lambda p: SparseJacobian(p, device='cpu'),
    'unfused': lambda p: SparseJacobian(p, fuse_gather=False, device='cpu'),
    'f32': lambda p: F32Jacobian(p, device='cpu'),
    'dense': lambda p: DenseJacobian(p, device='cpu'),
    'big': lambda p: BigJacobian(p, device='cpu'),
    'big_dense': lambda p: BigJacobian(p, sparse_cols=False, device='cpu'),
}


@pytest.mark.parametrize('kernel,module,name,B,ms', PERF_BOUNDS)
def test_roofline_reproduces_perf_bounds(kernel, module, name, B, ms):
    """Each row of PERF.md's table at its stated mechanism and B, to the
    table's 3 decimals, bound by bytes (K3's and K4's operations, K7's
    nonzero products, each under that)."""
    row = profiling.roofline(MODULES[module](_mech(name)[1]), B)[kernel]
    assert round(row['bound_ms'], 3) == ms
    assert row['bound_by'] == 'bytes'
    assert row['bound_ms'] == row['bytes'] / 3.35e12 * 1e3


def test_roofline_counts_the_outputs_bytes():
    """The bytes ``roofline`` counts from shapes are those of the real
    inputs and outputs, computed by the plain versions on the 9/24
    synth at B = 8 (each read once, written once)."""
    mech, p = _mech('synth')
    B = 8
    y, _, P = random_states(mech, B, seed=3)
    y_t = torch.as_tensor(np.ascontiguousarray(y.T))
    P_t = torch.as_tensor(P[None].copy())
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)

    sj = SparseJacobian(p, device='cpu')
    a = stage_a_reference(p, y_t, P_t, True)
    tabs = [t for k, t in sj._buffers.items()
            if k.startswith(('kp_', 'kf_', 'ka_'))]
    rows = profiling.roofline(sj, B)
    assert rows['stage_a']['bytes'] == nb(y_t, P_t, *tabs, *a.values())
    cols = sj.stage_b(a['src'], a['post'])
    assert rows['stage_b']['bytes'] == nb(
        a['src'], a['post'], sj.col_ptr, sj.col_src, sj.col_coef,
        sj.inv_mw, cols)

    dj = DenseJacobian(p, device='cpu')
    Jt, f = dj.call_tr(y_t, P_t)
    tabs = [t for k, t in dj._buffers.items() if k.startswith(('kp_', 'kf_'))]
    assert profiling.roofline(dj, B)['dense_fused']['bytes'] == nb(
        y_t, P_t, Jt, f, *tabs)

    bj = BigJacobian(p, device='cpu')
    st = state_thermo(bj.packed, y_t, P_t, True)
    roles = bj.parts(st)
    post = finish(bj.packed, st, roles, True)['post']
    p1c = bj.assemble_p1c(source_stack(roles, bj.Sf + bj.Sp, bj.eff_val))
    rows = profiling.roofline(bj, B)
    tabs = [t for k, t in bj._buffers.items() if k.startswith('kp_')]
    assert rows['big_parts']['bytes'] == nb(st['rows'], *tabs, roles)
    cols = bj.columns(roles, post)
    assert rows['big_cols_sparse']['bytes'] == nb(
        p1c, post, bj.ks_ptr, bj.ks_src, bj.ks_coef, bj.inv_mw, cols)
    with pytest.raises(TypeError):
        profiling.roofline(torch.nn.Linear(2, 2), B)


def test_roofline_counts_the_dydt_kernel():
    """The dy/dt kernel's row (a ``DenseJacobian``'s, beside K4's): the
    states and P read, f written and the tables K4's phases 0-4 read (not
    the column CSR), on the 9/24 synth at B = 8; its operations those of
    f alone, under K4's, and over the bytes' time at the flagship."""
    mech, p = _mech('synth')
    B = 8
    y, _, P = random_states(mech, B, seed=3)
    y_t = torch.as_tensor(np.ascontiguousarray(y.T))
    P_t = torch.as_tensor(P[None].copy())
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    dj = DenseJacobian(p, device='cpu')
    _, f = dj.call_tr(y_t, P_t)
    tabs = [t for k, t in dj._buffers.items()
            if k.startswith(('kp_', 'kf_')) and not k.startswith('kf_col_')]
    rows = profiling.roofline(dj, B)
    assert rows['dydt']['bytes'] == nb(y_t, P_t, f, *tabs)
    assert rows['dydt']['operations'] == profiling.dydt_ops(dj, B)
    assert 0 < rows['dydt']['operations'] < rows['dense_fused']['operations']
    flag = profiling.roofline(DenseJacobian(_mech('flagship')[1],
                                            device='cpu'), 32768)['dydt']
    assert flag['bound_by'] == 'operations'


def test_chip_smoke_takes_bounds_from_roofline():
    """``chip_smoke.py`` keeps no bound arithmetic of its own: its
    ``bound_ms`` come from ``profiling.roofline``, its peaks from here."""
    src = (pathlib.Path(__file__).resolve().parent.parent /
           'chip_smoke.py').read_text()
    assert 'roofline(' in src
    for gone in ('HBM_BYTES_S = ', 'F64_FLOP_S = ', 'def stage_a_bound',
                 'def dense_bound', 'def dense_ops', 'def nbytes'):
        assert gone not in src, gone


# per-state horizons: the first state is done before the loop starts,
# the others run out of their budget of 8 attempts, some rejected
HORIZONS = np.array([0.0, 1e-9, 2e-9, 1e-8])


def _integrate(method, n=len(HORIZONS)):
    """The plain path's integration of n random states of the 9/24
    synth at the horizons :data:`HORIZONS` repeated, 8 loop
    iterations."""
    mech, p = _mech('synth')
    y, _, P = random_states(mech, n, seed=3)
    return integrate(p, y, P, np.resize(HORIZONS, n), rtol=1e-3,
                     atol=1e-6, max_steps=8, method=method, device='cpu')


def _working_sets(attempts):
    """(rows computed, re-compactions) of the loop over states that took
    ``attempts``: before iteration i the states with more than i attempts
    are active, and the working set is the smallest size of the ladder
    that holds them, where that is smaller than the one before."""
    sizes = ladder(len(attempts))
    size, rows, compactions = len(attempts), 0, 0
    for i in range(int(attempts.max())):
        fit = min(s for s in sizes if s >= int((attempts > i).sum()))
        if fit < size:
            size, compactions = fit, compactions + 1
        rows += size
    return rows, compactions


def _profiled(fn):
    """(``fn()``, the profiler's events) under a CPU ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def test_spans_and_counters_are_off_without_a_profiler():
    """With no profiler a span is one shared null context and a count
    adds nothing, inside the integrator too."""
    profiling.counters.clear()
    assert profiling.span('a') is profiling.span('b')
    assert isinstance(profiling.span('a'), contextlib.nullcontext)
    assert not profiling.recording()
    profiling.count('integrate.state_slots', 3)
    _integrate('ros23')
    assert profiling.counters == {}


@pytest.mark.parametrize('n', [len(HORIZONS), 320])
@pytest.mark.parametrize('method,solves', [('ros23', 3), ('rodas3', 4)])
def test_integrate_spans_and_counters(method, solves, n):
    """Under a profiler a call records ``pyjac.integrate``, one
    ``iteration`` a loop iteration, and in each 3 ``dydt``, 1
    ``jacobian``, 1 ``lu_factor``, 3 (RODAS3 4) ``lu_solve`` and 1
    ``control``, and a ``compact`` in each that re-compacts; the
    counters hold the rows of every iteration's working set (B an
    iteration at B = 4, one size; at 320 a quarter of the states is done
    before the loop, which compacts to 256 first), the re-compactions and
    every step the states took; the results are bit-equal to an
    unprofiled call."""
    off = _integrate(method, n)
    profiling.counters.clear()
    on, events = _profiled(lambda: _integrate(method, n))
    for a, b in zip(off, on):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
    iters = on.iterations
    attempts = on.steps + on.rejected
    rows, compactions = _working_sets(attempts.numpy())
    assert compactions == (n > len(HORIZONS))
    it = 'pyjac.integrate.iteration'
    got = collections.Counter(
        (e.name, e.cpu_parent.name if e.cpu_parent else None)
        for e in events if e.name.startswith('pyjac.'))
    want = {('pyjac.integrate', None): 1,
            (it, 'pyjac.integrate'): iters,
            ('pyjac.integrate.dydt', it): 3 * iters,
            ('pyjac.integrate.jacobian', it): iters,
            ('pyjac.integrate.lu_factor', it): iters,
            ('pyjac.integrate.lu_solve', it): solves * iters,
            ('pyjac.integrate.control', it): iters,
            ('pyjac.integrate.compact', it): compactions}
    assert got == {k: v for k, v in want.items() if v}
    assert int(on.rejected.sum()) > 0
    want = {'integrate.state_slots': rows,
            'integrate.state_attempts': int(attempts.sum()),
            'integrate.compactions': compactions}
    assert profiling.counters == {k: v for k, v in want.items() if v}
    assert int(attempts.sum()) < n * iters
    if n == len(HORIZONS):
        assert rows == n * iters


def test_entry_span_holds_the_module_call():
    """``call_tr`` of a Jacobian module is one ``pyjac.jacobian`` span
    (on the CPU the plain versions, so no launch span)."""
    mech, p = _mech('synth')
    y, _, P = random_states(mech, 4, seed=3)
    y_t = torch.as_tensor(np.ascontiguousarray(y.T))
    P_t = torch.as_tensor(P[None].copy())
    for cls in (SparseJacobian, DenseJacobian, BigJacobian):
        mod = cls(p, device='cpu')
        _, events = _profiled(lambda: mod.call_tr(y_t, P_t))
        assert [e.name for e in events if e.name.startswith('pyjac.')] == \
            ['pyjac.jacobian']


@pytest.mark.parametrize('name', ['jacobian_dd_sparse', 'jacobian_dd'])
def test_export_under_a_profiler_holds_no_profiler_op(name):
    """An entry exported while a profiler records (on ``meta``, shapes
    only) calls the operators and no profiler op: under a tracer (here a
    fake tensor mode, as the export runs) a span is the null context."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    p = _mech('synth')[1]
    prog, _ = _profiled(lambda: libgen.export_kernel(p, name, True, 'meta'))
    called = [str(n.target) for n in prog.graph.nodes
              if n.op == 'call_function']
    assert any('pyjac_tpu_torch' in c for c in called)
    assert not any('profiler' in c for c in called), called

    def traced_span():
        with FakeTensorMode():
            return profiling.span('pyjac.jacobian')
    assert _profiled(traced_span)[0] is profiling.span('pyjac.jacobian')
