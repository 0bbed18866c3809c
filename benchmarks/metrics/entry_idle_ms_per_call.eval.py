"""entry_idle_ms_per_call.eval: milliseconds in which the card was idle
while the host was inside the program's ``pyjac.jacobian`` span (a
Jacobian module's ``call_tr``: argument checks, tile plan, allocation,
launches), per such span in the traced stretch; none where the program
opens no such span."""

from benchmarks.harness import spans

SPAN = 'pyjac.jacobian'


def read(run):
    if run.trace is None:
        return None
    n = len(spans.within(run.trace, (SPAN,)))
    s = spans.idle_s(run.trace, (SPAN,))
    return None if not n or s is None else 1e3 * s / n
