"""active_slots_pct: the share of the state rows the integrator's loop
computed that belonged to a state still integrating, in percent: 100
``integrate.state_attempts`` (the steps, accepted or rejected, the
states took) over ``integrate.state_slots`` (the rows each iteration
computed), the program's counters (``pyjac_tpu_torch.profiling.
counters``), which count only while a profiler records: over the
traced calls of the run's process.  None where they are empty (a
control, or a program without them)."""

import sys


def read(run):
    if run.trace is None:
        return None
    prof = sys.modules.get('pyjac_tpu_torch.profiling')
    counters = getattr(prof, 'counters', None) or {}
    slots = counters.get('integrate.state_slots', 0)
    if not slots:
        return None
    return 100.0 * counters.get('integrate.state_attempts', 0) / slots
