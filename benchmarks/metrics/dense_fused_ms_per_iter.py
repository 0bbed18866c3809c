"""dense_fused_ms_per_iter: device milliseconds of the op
``pyjac_tpu_torch::dense_fused`` (K4, ``csrc/dense_fused.cu``, the
stage Jacobian) per loop iteration of the traced calls."""


def read(run):
    its = sum(c.get('iterations', 0) for c in run.counters)
    if run.trace is None or not its:
        return None
    s = run.trace.op_device_s('pyjac_tpu_torch::dense_fused')
    return 1e3 * s / its if s else None
