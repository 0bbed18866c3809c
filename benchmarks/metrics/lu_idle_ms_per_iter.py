"""lu_idle_ms_per_iter: milliseconds in which the card was idle while
the host was inside the program's ``pyjac.integrate.lu_factor`` or
``pyjac.integrate.lu_solve`` spans (the library LU's factor and stage
solves, with their allocations), per loop iteration of the traced
calls; none where the program opens no such span."""

from benchmarks.harness import spans

SPANS = ('pyjac.integrate.lu_factor', 'pyjac.integrate.lu_solve')


def read(run):
    its = sum(c.get('iterations', 0) for c in run.counters)
    if run.trace is None or not its:
        return None
    s = spans.idle_s(run.trace, SPANS)
    return None if s is None else 1e3 * s / its
