"""dydt_ms_per_iter: device milliseconds under the program's
``pyjac.integrate.dydt`` spans (each plain dy/dt of the integrator's
loop, ``ops/dydt.py``: the kernels launched inside them) per loop
iteration of the traced calls; none where the program opens no such
span."""


def read(run):
    its = sum(c.get('iterations', 0) for c in run.counters)
    if run.trace is None or not its:
        return None
    s = run.trace.op_device_s('pyjac.integrate.dydt')
    return 1e3 * s / its if s else None
