"""lu_span_ms_per_iter: device milliseconds under the program's
``pyjac.integrate.lu_factor`` and ``pyjac.integrate.lu_solve`` spans (the
iteration matrix's factor and the stage solves: whatever kernels the
program launches inside them, a library's LU or its own) per loop
iteration of the traced calls; none where the program opens no such
span."""

SPANS = ('pyjac.integrate.lu_factor', 'pyjac.integrate.lu_solve')


def read(run):
    its = sum(c.get('iterations', 0) for c in run.counters)
    if run.trace is None or not its:
        return None
    s = sum(run.trace.op_device_s(n) or 0.0 for n in SPANS)
    return 1e3 * s / its if s else None
