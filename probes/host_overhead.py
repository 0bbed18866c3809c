"""Probe of the live modules' host cost per call on one CUDA card.

What it measures: ``SparseJacobian.call_tr`` (K1 + K2) and
``DenseJacobian.call_tr`` (K4) at the flagship (53 species, 325
reactions) on B = 256 and 4096 PaSR-like random states, and
``BigJacobian.call_tr`` at the 654-species / 2716-reaction class on
B = 64 random states, in its default configuration (K5 + K6) and with
``sparse_cols=False`` (K5 + K7), in two ways:

* ``sync``: one call then ``torch.cuda.synchronize()``, host clock,
  the median of 200 (what a loop that reads each result pays);
* ``queued``: 200 calls queued, then one sync, host clock per call
  (where the host is slower than the card, its cost per call).

Two turns, each module built anew.  The modules come from the package
on ``sys.path`` first: run it from a checkout's root to measure that
checkout, e.g. ``cd <checkout> && python3 <this file> <label>``, so two
trees are compared in one run on one card.  It prints the card's
``nvidia-smi`` line, a line per reading and one JSON line of them all.
It is not part of ``chip_smoke.py``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyjac_tpu_torch.ops.jacobian_big import BigJacobian  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import (  # noqa: E402
    flagship, packed_from_text, plausible_mechanism, random_states)

CALLS = 200


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()


def measure(fn):
    """(median sync ms, queued ms per call) of ``fn()``."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    sync = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        sync.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) / CALLS
    return statistics.median(sync) * 1e3, queued * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else 'tree'
    dev = torch.device('cuda', 0)
    card = card_line()
    print(card, flush=True)
    mech, packed = flagship()
    big = packed_from_text(plausible_mechanism(654, 2716, seed=5))[1]
    cases = ((packed, 256, (('sparse', SparseJacobian, {}),
                            ('dense', DenseJacobian, {}))),
             (packed, 4096, (('sparse', SparseJacobian, {}),
                             ('dense', DenseJacobian, {}))),
             (big, 64, (('big654', BigJacobian, {}),
                        ('big654_dense', BigJacobian,
                         {'sparse_cols': False}))))
    out = {'label': label, 'card': card, 'calls': CALLS, 'rows': []}
    for turn in (1, 2):
        for p, B, mods in cases:
            y, _, P = random_states(p.mech, B, seed=3)
            y_t = torch.as_tensor(np.ascontiguousarray(y.T), device=dev)
            P_t = torch.as_tensor(np.ascontiguousarray(P[None]), device=dev)
            for name, cls, kw in mods:
                mod = cls(p, device=dev, **kw)
                sync, queued = measure(lambda: mod.call_tr(y_t, P_t))
                row = dict(turn=turn, module=name, B=B, sync_ms=sync,
                           queued_ms=queued)
                out['rows'].append(row)
                print('%s turn %d %s B=%d: sync %.4f ms, queued %.4f ms a '
                      'call (%s)' % (label, turn, name, B, sync, queued,
                                     card), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
