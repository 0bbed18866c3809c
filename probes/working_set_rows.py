"""Probe of the integrator's kernels against the working set's rows, on
one CUDA card: where their time stops falling as the rows fall, which
sets ``integrate.FLOOR_ROWS``, the smallest working set of the loop.

What it does, at the integrate cell's mechanism (the 53-species
flagship, CONP, ``jacobian='dd'``, ROS23): for each working-set size W
it takes W of the PaSR flagship states (the 4032 of
``tests/data/flagship_states.npz``, tiled) with per-state step scales
s = h gamma drawn log-uniform over [1e-11, 3e-5] (seeded, as
``probes/batched_lu.py``), and runs REPS times each of the kernels an
iteration of the loop launches: K4 (``DenseJacobian.call_tr``), the dy/dt
kernel, the LU factor and the LU solve.  Under ``torch.profiler`` it
reads each one's device time a call (the sum of its kernels' records);
an iteration's kernels are K4, the factor, 3 solves and 2 dy/dt.  With
CUDA events it times ITERS such iterations enqueued back to back, with
no sync between them: the wall a loop iteration's kernels take, which
below some W is the host's enqueue and not the card.

It prints the card's ``nvidia-smi`` line, a line per W and one JSON line
of them all.  Run it from a checkout's root:
``python3 probes/working_set_rows.py``.
"""

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyjac_tpu_torch.ops import kernels  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import flagship  # noqa: E402

SIZES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 32768)
REPS = 20
ITERS = 20
OPS = torch.ops.pyjac_tpu_torch
# an iteration's launches of each kernel (ROS23, jacobian='dd')
PER_ITER = {'k4': 1, 'lu_factor': 1, 'lu_solve': 3, 'dydt': 2}


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()


def device_ms(fn) -> float:
    """Device ms a call of ``fn``: its kernels' records under the
    profiler over REPS calls, after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA}
    us = sum(e.time_range.end - e.time_range.start for e in events
             if e.device_type == DeviceType.CUDA and e.name not in ranges)
    return us * 1e-3 / REPS


def wall_ms(fn) -> float:
    """Median over 5 turns of the ms an ``fn()`` takes with ITERS of
    them enqueued back to back, CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(ITERS):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / ITERS)
    return statistics.median(out)


def at(W, dense, d, card) -> dict:
    idx = np.arange(W) % len(d['y'])
    y_t = torch.as_tensor(d['y'][idx].T.copy(), device=card)
    P_t = torch.as_tensor(d['P'][None, idx].copy(), device=card)
    rng = np.random.default_rng(17)
    s = torch.as_tensor(10.0 ** rng.uniform(-11, np.log10(3e-5), W),
                        device=card)
    Jt, f = dense.call_tr(y_t, P_t)
    J = Jt.permute(2, 1, 0)
    LU, piv, _ = OPS.lu_factor(J, s)
    rhs = f.T.contiguous()
    fns = {'k4': lambda: dense.call_tr(y_t, P_t),
           'lu_factor': lambda: OPS.lu_factor(J, s),
           'lu_solve': lambda: OPS.lu_solve(LU, piv, rhs),
           'dydt': lambda: kernels.dydt(dense, y_t, P_t)}

    def iteration():
        for name, n in PER_ITER.items():
            for _ in range(n):
                fns[name]()

    t = {name: device_ms(fn) for name, fn in fns.items()}
    t['iter_device'] = sum(n * t[name] for name, n in PER_ITER.items())
    t['iter_wall'] = wall_ms(iteration)
    return t


def main():
    card = torch.device('cuda', 0)
    line = card_line()
    print(line)
    _, p = flagship()
    dense = DenseJacobian(p, device=card)
    d = np.load(os.path.join('tests', 'data', 'flagship_states.npz'))
    out = {'card': line}
    print('ms a call (device, profiler) and an iteration (K4, factor, 3 '
          'solves, 2 dy/dt: device sum; wall of %d back to back):' % ITERS)
    for W in SIZES:
        t = at(W, dense, d, card)
        out[W] = t
        print('W %6d: ' % W + ', '.join('%s %.4f' % kv for kv in t.items()))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
