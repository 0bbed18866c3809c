"""One run of one cell: set-up, warm-up, the measured window (or, with
``trace``, a traced stretch), the comparison with the plain reference,
and the result line.

Used by ``run.py`` on the card, and by the tests on the CPU at small
sizes (``overrides``)."""

from __future__ import annotations

import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from . import bound, compare, inputs
from . import trace as tracing
from .cells import Cell, module

# top-level module names the process may not hold once the window closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pyjac_tpu', 'bench')
HOST_SPAN_S = 1.0         # --trace 1: the untraced stretch of host spans
TRACE_MIN_S = 0.5         # --trace 1: the traced stretch's least length


@dataclass
class Context:
    """What a call module's ``Program`` / ``Control`` is built from."""
    mech_path: object
    conp: bool
    states: inputs.States
    traffic: dict
    device: torch.device
    ref: object
    mech: object
    block: int


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)
    -> float or None``)."""
    cell: Cell
    states_per_call: int
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    call_s: List[float] = field(default_factory=list)
    host_call_s: List[float] = field(default_factory=list)
    counters: List[dict] = field(default_factory=list)
    trace: Optional[object] = None
    bound: Optional[dict] = None


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def _wait_all(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _window(program, seconds: float, device, keep: set, run: Run):
    """Calls until ``seconds`` have passed; each call's time from the
    card's events around it (on the CPU, the host clock); returns
    {index: output} of ``keep`` and the last call, and every call's
    status where the program has one."""
    cuda = device.type == 'cuda'
    marks, kept, statuses = [], {}, []
    _wait_all(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        if cuda:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
        else:
            h0 = time.perf_counter()
        out = program.call()
        if cuda:
            e.record()
        program.wait(out)
        t1 = time.perf_counter()
        marks.append((s, e) if cuda else t1 - h0)
        run.counters.append(program.counters(out))
        if hasattr(program, 'status'):
            statuses.append(program.status(out))
        if n in keep:
            kept[n] = out
        n += 1
        if t1 - t0 >= seconds:
            break
    kept[n - 1] = out
    run.window_s = t1 - t0
    run.calls = n
    run.call_s = [s.elapsed_time(e) * 1e-3 for s, e in marks] if cuda \
        else marks
    return kept, statuses


def _host_spans(program, seconds: float, run: Run):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        h0 = time.perf_counter()
        out = program.call()
        run.host_call_s.append(time.perf_counter() - h0)
        program.wait(out)


def _power_limit() -> str:
    try:
        p = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else ''
    except (OSError, subprocess.SubprocessError):
        return ''


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             control: bool = False, t_start: Optional[float] = None,
             overrides: Optional[dict] = None, log=sys.stderr) -> dict:
    """The result line's dict of one run (``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == 'cuda'
    traffic = dict(cell.traffic, **(overrides or {}))
    config = cell.config
    call_mod = module('calls', traffic['call'])
    ref = module('reference', config['reference'])
    text = inputs.mechanism_text(config)
    mech = ref.Mechanism(text)
    states = inputs.draw_states(config, traffic, seed)
    ctx = Context(inputs.mechanism_file(config, text), bool(config['conp']),
                  states, traffic, device, ref, mech,
                  compare.block_size(mech))
    program = (call_mod.Control if control else call_mod.Program)(ctx)
    B = program.states
    run = Run(cell=cell, states_per_call=B)
    run.bound = bound.jacobian_bound(mech, B, traffic['dtype'])

    # warm-up: every shape the window uses, with as many outputs alive
    warm = [None] * (0 if control else int(traffic.get('warmup_calls', 1)))
    w0 = time.perf_counter()
    for k in range(len(warm)):
        warm[k] = program.call()
        program.wait(warm[k])
    call_est = (time.perf_counter() - w0) / max(len(warm), 1)
    del warm
    _wait_all(device)
    run.setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng([int(seed), 7])
    if trace:
        _host_spans(program, HOST_SPAN_S, run)
        n_min = int(traffic.get('trace_calls', 1))
        keep = {int(rng.integers(0, n_min))}
        tr, kept, counters = tracing.profile_calls(
            program, n_min, TRACE_MIN_S, device, keep)
        run.trace, run.counters, run.calls = tr, counters, tr.calls
        run.window_s = tr.window_s
        statuses = [program.status(o) for o in kept.values()] \
            if hasattr(program, 'status') else []
    else:
        expect = max(1, int(seconds / max(call_est, 1e-9)))
        keep = {int(rng.integers(0, expect))}
        kept, statuses = _window(program, seconds, device, keep, run)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    outs = list(kept.values())
    program.free()
    if cuda:
        torch.cuda.empty_cache()

    tables = mech.tensors(device)
    if call_mod.kind == 'jacobian':
        nums = compare.jacobian_numbers(ref, mech, tables, states, program,
                                        outs, device)
        failed = nums.pop('nonfinite')
    else:
        nums = compare.integrate_numbers(ref, mech, tables, states, program,
                                         outs, device, traffic['integrate'])
        nums['unfinished'] = int(sum(int((s != 0).sum()) for s in statuses))
        failed = nums['unfinished']
    checks = {k: {'value': v, 'limit': cell.limits[k]['limit']}
              for k, v in nums.items()}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit']
                  for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = module('metrics', m['name']).read(run)
        if v is not None:
            metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': 1, 'memory_peak_bytes': int(peak)}
    out = {'correct': bool(correct), 'attempted': int(run.calls * B),
           'failed': int(failed), 'metrics': metrics, 'device': dev}
    if trace and run.trace is not None:
        dev['busy_s'] = run.trace.busy_s
        dev['window_s'] = run.trace.window_s
        out['breakdown'] = {'device_ops': run.trace.device_ops(),
                            'idle_gaps': run.trace.idle_gaps()}
    if cuda:
        dev['power'] = _power_limit()
    its = [c['iterations'] for c in run.counters if 'iterations' in c]
    print('%s seed %d: %d calls of %d states, setup %.3f s, window %.3f s%s%s'
          % (cell.name, seed, run.calls, B, run.setup_s, run.window_s,
             ', iterations %s' % sorted(set(its)) if its else '',
             ' (control)' if control else ''), file=log)
    for k, c in checks.items():
        print('check %s %.6e limit %.6e' % (k, c['value'], c['limit']),
              file=log)
    out['checks'] = checks
    return out
