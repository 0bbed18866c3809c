"""The share of the traced stretch in which no kernel, copy or set ran
on the card, in percent: 100 (1 - busy / window), with busy the union
of the device records and the window from the first traced call's start
to the last one's wait."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
