"""The device trace of a stretch of calls: ``torch.profiler`` with the
card's activity, read into kernel intervals, per-op device time and the
breakdown of the result line."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


class Trace:
    """Kernel records ``kernels`` [(name, start_us, end_us)], host
    records ``host`` [(name, start_us, end_us)], each op's device time
    ``op_s`` (a record's kernels and its children's, top-level records
    of a name only), and the traced window [``t0``, ``t1``] (us)."""

    def __init__(self, events, calls: int):
        from torch.autograd import DeviceType
        self.calls = calls
        self.host = []
        self.op_s: Dict[str, float] = {}
        device = []
        for ev in events:
            tr = ev.time_range
            if ev.device_type == DeviceType.CUDA:
                device.append((ev.name, tr.start, tr.end))
                continue
            self.host.append((ev.name, tr.start, tr.end))
            par = ev.cpu_parent
            while par is not None and par.name != ev.name:
                par = par.cpu_parent
            if par is None and ev.device_time_total > 0:
                self.op_s[ev.name] = (self.op_s.get(ev.name, 0.0) +
                                      ev.device_time_total * 1e-6)
        # a host range (record_function) is also drawn on the device's
        # timeline, over its kernels: it is no device record
        ranges = {n for n, _, _ in self.host}
        self.kernels = [k for k in device if k[0] not in ranges]
        marks = [(s, e) for n, s, e in self.host
                 if n in ('bench.call', 'bench.wait')]
        self.t0 = min(s for s, _ in marks)
        self.t1 = max(e for _, e in marks)
        self.kernels.sort(key=lambda k: k[1])
        self.busy = self._union()

    def _union(self) -> List[tuple]:
        out = []
        for _, s, e in self.kernels:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def op_device_s(self, name: str) -> Optional[float]:
        """Device seconds of the ops named ``name``; None if none ran."""
        return self.op_s.get(name)

    def device_ops(self, top: int = 10) -> list:
        by: Dict[str, float] = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds of the device, by the host records open at each
        gap's midpoint (outermost / innermost), in one sweep."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        by: Dict[str, float] = {}
        stack, i = [], 0
        for a, b in gaps:
            m = 0.5 * (a + b)
            while i < len(host) and host[i][1] <= m:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            open_ = [h for h in stack if h[2] >= m]
            if not open_:
                label = 'host outside any record'
            elif len(open_) == 1:
                label = open_[0][0]
            else:
                label = '%s / %s' % (open_[0][0], open_[-1][0])
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def profile_calls(program, min_calls: int, min_s: float, device, keep):
    """Run calls of ``program`` under the profiler until at least
    ``min_calls`` calls and ``min_s`` seconds; returns (Trace, {index:
    output} of the calls ``keep`` names and the last, counters)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    kept, counters, n = {}, [], 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while n < min_calls or time.perf_counter() - t0 < min_s:
            with record_function('bench.call'):
                out = program.call()
            with record_function('bench.wait'):
                program.wait(out)
            counters.append(program.counters(out))
            if n in keep:
                kept[n] = out
            n += 1
    kept[n - 1] = out
    return Trace(prof.events(), n), kept, counters
