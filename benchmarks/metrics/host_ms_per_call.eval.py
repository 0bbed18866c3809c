"""host_ms_per_call.eval: the mean host time of the entry call, from
the call to its return, before the sync; over an untraced stretch of
calls after the warm-up.  The benchmark's own span, host clock."""


def read(run):
    if not run.host_call_s:
        return None
    return 1e3 * sum(run.host_call_s) / len(run.host_call_s)
