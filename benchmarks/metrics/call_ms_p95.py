"""call_ms_p95: the 95th percentile over every call of the window of
one call's time: the card's events recorded on the stream before the
entry call and after it, so the host's enqueue of the call is inside,
and the wait for the result (one synchronize) after it.  The percentile
is ``statistics.quantiles``' (exclusive method)."""

import statistics


def read(run):
    if run.trace is not None or len(run.call_s) < 2:
        return None
    return statistics.quantiles(run.call_s, n=100)[94] * 1e3
