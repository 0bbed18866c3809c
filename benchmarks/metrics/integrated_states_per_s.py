"""integrated_states_per_s: states the window's calls advanced through
the flow step, over the window (the first call's start to the last
call's end).  Host clock."""


def read(run):
    if run.trace is not None or not run.calls:
        return None
    return run.calls * run.states_per_call / run.window_s
