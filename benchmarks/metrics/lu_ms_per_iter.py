"""lu_ms_per_iter: device milliseconds of the ops
``aten::linalg_lu_factor_ex`` and ``aten::linalg_lu_solve`` (the
iteration matrix's factor and the stage solves) per loop iteration of
the traced calls."""

OPS = ('aten::linalg_lu_factor_ex', 'aten::linalg_lu_solve')


def read(run):
    its = sum(c.get('iterations', 0) for c in run.counters)
    if run.trace is None or not its:
        return None
    s = sum(run.trace.op_device_s(o) or 0.0 for o in OPS)
    return 1e3 * s / its if s else None
