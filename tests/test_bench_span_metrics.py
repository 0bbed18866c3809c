"""The benchmark's readers of the port's spans and counters
(``benchmarks/metrics/{dydt_ms_per_iter, lu_idle_ms_per_iter,
lu_span_ms_per_iter, active_slots_pct, entry_idle_ms_per_call.eval,
stage_b_write_pct}.py`` and
``benchmarks/harness/spans.py``) on a hand-built trace: the profiler's
events as ``harness/trace.py`` reads them, with known host spans,
kernel intervals and device times, so that every idle sum and ratio is
known; and the None each gives where there is nothing to read (an
untraced run, a control, a program without the spans)."""

import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmarks.harness import spans
from benchmarks.harness.cells import module
from benchmarks.harness.runner import Run
from benchmarks.harness.trace import Trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, start, end, device=CPU, device_us=0.0):
    return SimpleNamespace(name=name, device_type=device, cpu_parent=None,
                           device_time_total=device_us,
                           time_range=SimpleNamespace(start=start, end=end))


# two calls and their waits: the window is [0, 210] us
CALLS = [_ev('bench.call', 0, 100), _ev('bench.wait', 100, 110),
         _ev('bench.call', 110, 200), _ev('bench.wait', 200, 210)]
# the card busy over [20, 45] and [65, 130]
KERNELS = [_ev('k_a', 20, 45, CUDA), _ev('k_b', 65, 100, CUDA),
           _ev('k_c', 90, 130, CUDA)]


def _drawn(name):
    """A span's range as the profiler also draws it on the device's
    timeline, over its kernels: no kernel."""
    return [_ev(name, 0, 200, CUDA)]


def _integrate_trace():
    """The LU spans: [10, 30] (idle 10), an overlapping solve [12, 25]
    (covered already), [40, 50] (idle 5), [60, 70] (idle 5), [120, 140]
    (idle 10), [205, 215] (clipped to the window: idle 5) and [300,
    320] (outside it): 35 us idle.  dy/dt: 1500 + 500 us of device
    time."""
    host = [_ev('pyjac.integrate.lu_factor', 10, 30),
            _ev('pyjac.integrate.lu_solve', 12, 25),
            _ev('pyjac.integrate.lu_solve', 40, 50),
            _ev('pyjac.integrate.lu_solve', 60, 70),
            _ev('pyjac.integrate.lu_factor', 120, 140),
            _ev('pyjac.integrate.lu_solve', 205, 215),
            _ev('pyjac.integrate.lu_solve', 300, 320),
            _ev('pyjac.integrate.dydt', 5, 15, device_us=1500.0),
            _ev('pyjac.integrate.dydt', 150, 160, device_us=500.0)]
    return Trace(CALLS + host + KERNELS + _drawn('pyjac.integrate.dydt'), 2)


def _eval_trace():
    """Two entry spans: [0, 30] (idle 20) and [110, 140] (idle 10)."""
    host = [_ev('pyjac.jacobian', 0, 30), _ev('pyjac.jacobian', 110, 140)]
    return Trace(CALLS + host + KERNELS + _drawn('pyjac.jacobian'), 2)


def _run(trace, iterations=(2, 1)):
    return Run(cell=None, states_per_call=4, trace=trace,
               counters=[{'iterations': n} for n in iterations])


def _read(name, run):
    return module('metrics', name).read(run)


def test_the_trace_and_the_idle_sums():
    tr = _integrate_trace()
    assert (tr.t0, tr.t1) == (0, 210)
    assert tr.busy == [(20, 45), (65, 130)]
    assert tr.op_device_s('pyjac.integrate.dydt') == pytest.approx(2e-3)
    assert spans.within(tr, ['pyjac.integrate.lu_solve'])[-1] == (205, 210)
    assert spans.idle_s(tr, ['pyjac.integrate.lu_factor']) == \
        pytest.approx(20e-6)
    lu = module('metrics', 'lu_idle_ms_per_iter').SPANS
    assert spans.idle_s(tr, lu) == pytest.approx(35e-6)
    assert spans.idle_s(tr, ['pyjac.jacobian']) is None


def test_integrate_readers():
    run = _run(_integrate_trace())
    assert _read('dydt_ms_per_iter', run) == pytest.approx(2.0 / 3)
    assert _read('lu_idle_ms_per_iter', run) == pytest.approx(0.035 / 3)
    assert _read('lu_idle_ms_per_iter', _run(_integrate_trace(), (7,))) \
        == pytest.approx(0.005)


def _lu_trace(library: bool):
    """A factor and three solves over each of two iterations, their spans
    holding device time: factor 900 + 600 us, solves 6 x 100 us.  Inside
    each span the op it ran: the library's ``aten::linalg_*`` (parent)
    or the port's ``pyjac_tpu_torch::lu_*`` (change), each holding its
    span's device time; a nested span of the same name is its parent's
    and counts once."""
    host, t = [], 0
    for factor_us in (900.0, 600.0):
        for name, us in [('lu_factor', factor_us)] + [('lu_solve', 100.0)] * 3:
            span = _ev('pyjac.integrate.' + name, t, t + 5, device_us=us)
            op = ('aten::linalg_%s' % ('lu_factor_ex' if name == 'lu_factor'
                                        else name) if library
                  else 'pyjac_tpu_torch::' + name)
            child = _ev(op, t + 1, t + 4, device_us=us)
            child.cpu_parent = span
            host += [span, child]
            t += 6
    inner = _ev('pyjac.integrate.lu_solve', 2, 3, device_us=50.0)
    inner.cpu_parent = host[2]
    return Trace(CALLS + host + [inner] + KERNELS +
                 _drawn('pyjac.integrate.lu_factor'), 2)


@pytest.mark.parametrize('library', [True, False], ids=['parent', 'change'])
def test_lu_span_reader(library):
    """``lu_span_ms_per_iter`` reads the device time under the LU spans,
    2.1 ms over 3 iterations, whichever LU ran inside them;
    ``lu_ms_per_iter`` reads only the library's ops."""
    run = _run(_lu_trace(library))
    assert _read('lu_span_ms_per_iter', run) == pytest.approx(0.7)
    lu = _read('lu_ms_per_iter', run)
    assert lu == pytest.approx(0.7) if library else lu is None


def test_entry_idle_reader():
    run = _run(_eval_trace(), ())
    assert _read('entry_idle_ms_per_call.eval', run) == pytest.approx(0.015)


def test_active_slots_reader(monkeypatch):
    from pyjac_tpu_torch import profiling
    run = _run(_integrate_trace())
    monkeypatch.setattr(profiling, 'counters', {
        'integrate.state_slots': 200, 'integrate.state_attempts': 74})
    assert _read('active_slots_pct', run) == pytest.approx(37.0)
    assert _read('active_slots_pct', _run(None)) is None
    monkeypatch.setattr(profiling, 'counters', {})
    assert _read('active_slots_pct', run) is None
    monkeypatch.delitem(sys.modules, 'pyjac_tpu_torch.profiling')
    assert _read('active_slots_pct', run) is None


def _k2_run(n_species, batch, stage_b_us):
    """Two calls, each with one ``pyjac_tpu_torch::stage_b`` record of
    ``stage_b_us`` microseconds of device time."""
    host = [_ev('pyjac_tpu_torch::stage_b', 40, 50, device_us=stage_b_us),
            _ev('pyjac_tpu_torch::stage_b', 150, 160, device_us=stage_b_us)]
    cell = SimpleNamespace(config={'n_species': n_species})
    return Run(cell=cell, states_per_call=batch,
               trace=Trace(CALLS + host + KERNELS, 2))


@pytest.mark.parametrize('n_species,batch,stage_b_us,pct', [
    # the J K2 writes a call, (N - 1) N 8 B bytes, at 3.35e12 B/s
    (654, 4096, 7000.0, 100 * 653 * 654 * 8 * 4096 / 3.35e12 / 7e-3),
    (53, 131072, 2960.0, 100 * 52 * 53 * 8 * 131072 / 3.35e12 / 2.96e-3),
    (654, 4096, 653 * 654 * 8 * 4096 / 3.35e12 * 1e6, 100.0)])
def test_stage_b_write_pct_reader(n_species, batch, stage_b_us, pct):
    run = _k2_run(n_species, batch, stage_b_us)
    assert _read('stage_b_write_pct', run) == pytest.approx(pct)


def test_stage_b_write_pct_gives_none_where_k2_did_not_run():
    assert _read('stage_b_write_pct', _run(None)) is None
    run = _run(_eval_trace())
    run.cell = SimpleNamespace(config={'n_species': 53})
    assert _read('stage_b_write_pct', run) is None


@pytest.mark.parametrize('name', ['dydt_ms_per_iter', 'lu_idle_ms_per_iter',
                                  'entry_idle_ms_per_call.eval',
                                  'lu_span_ms_per_iter'])
def test_readers_give_none_where_nothing_is_read(name):
    """No trace (an untraced run); a trace without the program's spans
    (a program without them, or a control); a trace with no device
    record (a run on the CPU); no loop iterations."""
    assert _read(name, _run(None)) is None
    bare = Trace(CALLS + KERNELS, 2)
    assert _read(name, _run(bare)) is None
    if name != 'dydt_ms_per_iter':
        # off the card: spans, no device record
        host = [_ev(n, 10, 30) for n in ('pyjac.jacobian',
                                         'pyjac.integrate.lu_factor')]
        assert _read(name, _run(Trace(CALLS + host, 2))) is None
    if name != 'entry_idle_ms_per_call.eval':
        assert _read(name, _run(_integrate_trace(), ())) is None
