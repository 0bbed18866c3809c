"""Probe of the eval entry's host path on one CUDA card, split by the
port's own spans.

What it measures: ``call_tr`` of ``SparseJacobian`` (K1 + K2) at the
flagship (53 species, 325 reactions) on B = 131072 and at the USC-II
class (111 / 784) on 32768, and of ``F32Jacobian`` (K3) at the flagship
on 262144 random states: the benchmark's three eval cells' shapes.
Each call is followed by ``torch.cuda.synchronize()``, as the
benchmark's closed loop does, and ``CALLS`` calls run under
``profiling.trace``.  For each span it prints the mean host
milliseconds a call: ``pyjac.jacobian`` (the whole entry),
``pyjac.kernels.prepare`` and its self time (less its children
``plan`` and ``alloc``), ``plan``, ``alloc`` and ``launch``, summed
over the call's launches.  The times are the profiler's: each span and
each op inside it adds its own record's cost.

Run from a checkout's root: ``python3 probes/entry_spans.py``.  It
prints the card's ``nvidia-smi`` line, a line per module and one JSON
line of them all.  It is not part of ``chip_smoke.py``.
"""

import collections
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from pyjac_tpu_torch import profiling  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import (flagship,  # noqa: E402
                                               packed_from_text,
                                               plausible_mechanism,
                                               random_states)

CALLS = 50
SPANS = ('pyjac.jacobian', 'pyjac.kernels.prepare', 'pyjac.kernels.plan',
         'pyjac.kernels.alloc', 'pyjac.kernels.launch')


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()


def split(mod, y_t, P_t) -> dict:
    """{span: mean host ms a call} of ``CALLS`` profiled calls."""
    for _ in range(5):
        mod.call_tr(y_t, P_t)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            for _ in range(CALLS):
                mod.call_tr(y_t, P_t)
                torch.cuda.synchronize()
    total = collections.defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in SPANS:
            total[ev.name] += ev.time_range.elapsed_us() * 1e-3
    out = {k: total[k] / CALLS for k in SPANS}
    out['prepare_self'] = (out['pyjac.kernels.prepare'] -
                           out['pyjac.kernels.plan'] -
                           out['pyjac.kernels.alloc'])
    return out


def states(mech, B, dtype):
    y, _, P = random_states(mech, B, seed=11)
    return (torch.as_tensor(np.ascontiguousarray(y.T), dtype=dtype,
                            device='cuda'),
            torch.as_tensor(P[None].copy(), dtype=dtype, device='cuda'))


def main():
    print(card_line())
    flag, fp = flagship()
    usc, up = packed_from_text(plausible_mechanism(111, 784, seed=5))
    rows = {}
    for label, make, mech, B, dtype in (
            ('sparse-gri30-B131072', lambda: SparseJacobian(fp), flag,
             131072, torch.float64),
            ('sparse-usc2-B32768', lambda: SparseJacobian(up), usc, 32768,
             torch.float64),
            ('f32-gri30-B262144', lambda: F32Jacobian(fp), flag, 262144,
             torch.float32)):
        rows[label] = split(make(), *states(mech, B, dtype))
        print(label, ' '.join('%s %.4f' % (k.split('.')[-1], v)
                              for k, v in rows[label].items()))
    print(json.dumps(rows))


if __name__ == '__main__':
    main()
