"""evals_per_s: states whose J and dy/dt the window's calls completed,
over the window (the first call's start to the last call's end).  Host
clock."""


def read(run):
    if run.trace is not None or not run.calls:
        return None
    return run.calls * run.states_per_call / run.window_s
