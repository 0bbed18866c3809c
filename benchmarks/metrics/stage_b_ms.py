"""stage_b_ms: device milliseconds a call of the op
``pyjac_tpu_torch::stage_b`` (K2, ``csrc/sparse_stage_b.cu``) takes, per
traced call; none where the op did not run."""


def read(run):
    s = run.trace.op_device_s('pyjac_tpu_torch::stage_b') if run.trace \
        else None
    return None if not s else 1e3 * s / run.trace.calls
