"""jacobian_roofline: the evaluation's least time on the card
(``harness/bound.py``: the states read and J and dy/dt written once, or
the closed-form operations, at the data sheet's peaks) over the device
time of its kernels per traced call, in percent.  It reads the same
work whatever kernels implement it."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * run.bound['least_s'] / (run.trace.busy_s /
                                          run.trace.calls)
