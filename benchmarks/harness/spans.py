"""The card's idle time under the program's own spans: the part of the
traced stretch in which the host was inside a record of given names
(the ``profiling.span`` ranges of ``pyjac_tpu_torch``) while no kernel,
copy or set ran on the card.  Read from a ``trace.Trace``'s ``host``
records and ``busy`` intervals within its window [``t0``, ``t1``] (us);
where the program opens no such span, as one without them, or the card
ran nothing in the window (a run off the card), it gives None."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def within(trace, names: Iterable[str]) -> List[Tuple[float, float]]:
    """The host records named in ``names`` that reach into the window,
    each clipped to it: [(start_us, end_us)]."""
    names = set(names)
    return [(max(s, trace.t0), min(e, trace.t1)) for n, s, e in trace.host
            if n in names and min(e, trace.t1) > max(s, trace.t0)]


def _union(ivs) -> list:
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_s(trace, names: Iterable[str]) -> Optional[float]:
    """Seconds in which the host was inside a record named in ``names``
    and the card was idle (the union of those records less the card's
    busy intervals); None where no such record reaches into the window
    or no device record lies in it."""
    spans = _union(within(trace, names))
    if not spans or not trace.busy:
        return None
    busy, i, idle = trace.busy, 0, 0.0
    for s, e in spans:
        idle += e - s
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            idle -= min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return idle * 1e-6
