"""Headline benchmark of the port: analytical Jacobian + dy/dt throughput
on one CUDA card.

Counterpart of the JAX package's ``bench.py``: the same three cells, the
same states and timing rule, on the 53-species / 325-reaction flagship
(``testers.synthetic.flagship()``):

* the headline: the PaSR states of ``tests/data/flagship_states.npz``
  tiled to B = 131072 through ``SparseJacobian`` (K1 + K2;
  ``DenseJacobian``, K4, where ``SparseJacobian`` refuses), f64; one
  untimed call, then 3
  passes of 8 queued calls with one host sync each on a ``torch.sum`` of
  every output;
* 1,048,576 device-resident states through
  ``BatchEvaluator.jacobian_dd_resident`` in chunks of 131072, with the
  one-time staging reported apart;
* the f32 kernel K3 (``F32Jacobian``) on ``random_states(mech, 262144,
  seed=1, T_range=(1500, 2500))``, 3 passes of 6, reported on standard
  error only.

Prints ONE JSON line on standard output::

  {"metric": "gri_scale_jacobian_dydt_throughput_f64", "value": evals/s,
   "unit": "evals/sec/card", "value_1m_chunked": ..., "staging_1m_s": ...}

There is no ``vs_baseline``: the JAX bench's 1e6 target is a figure per
TPU v5e chip (``BASELINE.json``), no target for this card.  Without a
CUDA card it exits non-zero and prints no JSON line.

Run from the repository root: ``python -m pyjac_tpu_torch.bench``.
"""

from __future__ import annotations

import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

from .ops.jacobian_f32 import F32Jacobian, supports
from .parallel.batch import BatchEvaluator
from .testers.synthetic import flagship, random_states

STATES = (pathlib.Path(__file__).resolve().parent.parent / 'tests' / 'data' /
          'flagship_states.npz')
METRIC = 'gri_scale_jacobian_dydt_throughput_f64'


def bench_states(B):
    """(mech, packed, y (B, N), P (B,), kind): the benchmark ensemble,
    the flagship's PaSR states tiled to B (uniform-random states when the
    file is missing, as the JAX bench)."""
    mech, packed = flagship()
    if STATES.exists():
        d = np.load(STATES)
        reps = -(-B // len(d['y']))
        y = np.tile(d['y'], (reps, 1))[:B]
        P = np.tile(d['P'], reps)[:B]
        kind = 'PaSR (%d base)' % len(d['y'])
    else:
        y, _, P = random_states(mech, B, seed=1, T_range=(1500.0, 2500.0))
        kind = 'uniform-random'
    return mech, packed, y.astype(np.float64), P.astype(np.float64), kind


def _passes(fn, repeats, queue):
    """Best per-call seconds: ``repeats`` passes of ``queue`` queued
    calls of ``fn`` (each returning device checksums), one host sync per
    pass; raises on a non-finite checksum."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        acc = float(sum(sum(fn()) for _ in range(queue)))
        times.append((time.perf_counter() - t0) / queue)
        if not math.isfinite(acc):
            raise RuntimeError('non-finite benchmark output')
    return min(times), times


def run(device='cuda', log=sys.stderr, B=131072, B1m=1048576,
        Bp=262144) -> dict:
    """The three cells on ``device`` at batches ``B`` (headline), ``B1m``
    (device-resident, in chunks of ``B``) and ``Bp`` (f32); returns the
    JSON line's dict plus ``detail`` (times, the 1M stats, the f32 rate).
    Raises on a non-finite output."""
    repeats, queue = 3, 8
    mech, packed, y, P, kind = bench_states(B)
    print('bench states: %s' % kind, file=log)
    ev = BatchEvaluator(packed, chunk_size=B, device=device)
    mod = ev._dd_kernel()
    y_t = torch.as_tensor(y.T.copy(), device=device)
    P_t = torch.as_tensor(P[None].copy(), device=device)

    def headline():
        return [torch.sum(x) for x in mod.call_tr(y_t, P_t)]

    t0 = time.perf_counter()
    if not math.isfinite(float(sum(headline()))):
        raise RuntimeError('non-finite benchmark output')
    print('build + first call: %.1f s (%s)' % (time.perf_counter() - t0,
                                                type(mod).__name__), file=log)
    best, times = _passes(headline, repeats, queue)
    print('times per %d-state pass: %s' % (
        B, ['%.6f' % t for t in times]), file=log)
    del y_t, P_t

    _, _, y1m, P1m, _ = bench_states(B1m)
    chk1m, st1m = ev.jacobian_dd_resident(y1m, P1m, chunk_b=B)
    if not math.isfinite(chk1m):
        raise RuntimeError('non-finite 1M-chunked benchmark output')
    print('1M-state device-resident chunked f64: %.0f evals/s/card (compute '
          '%.4f s over %d x %d-state chunks, %s; one-time staging %.4f s = '
          '%.0f MB at %.1f MB/s host->device; first pass %.2f s)'
          % (st1m['evals_per_s'], st1m['compute_s'], st1m['n_chunks'],
             st1m['chunk_b'], st1m['kernel'], st1m['staging_s'],
             st1m['staging_bytes'] / 1e6, st1m['staging_mb_s'],
             st1m['compile_s']), file=log)
    del y1m, P1m, ev

    rate_f32 = None
    if supports(packed):
        pf = F32Jacobian(packed, device=device)
        yp, _, Pp = random_states(mech, Bp, seed=1, T_range=(1500.0, 2500.0))
        ytr = torch.as_tensor(yp.T.copy(), dtype=torch.float32, device=device)
        Prow = torch.as_tensor(Pp[None].copy(), dtype=torch.float32,
                               device=device)

        def f32_cell():
            return [torch.sum(x) for x in pf.call_tr(ytr, Prow)]

        if not math.isfinite(float(sum(f32_cell()))):
            raise RuntimeError('non-finite f32 benchmark output')
        rate_f32 = Bp / _passes(f32_cell, 3, 6)[0]
        print('f32 kernel K3: %.0f evals/s/card (B=%d)' % (rate_f32, Bp),
              file=log)

    out = {'metric': METRIC, 'value': round(B / best, 1),
           'unit': 'evals/sec/card',
           'value_1m_chunked': round(st1m['evals_per_s'], 1),
           'staging_1m_s': round(st1m['staging_s'], 4)}
    return dict(out, detail=dict(pass_s=times, stats_1m=st1m,
                                 f32_evals_per_s=rate_f32))


def main() -> int:
    if not torch.cuda.is_available():
        print('bench: no CUDA card available; the benchmark measures the '
              'card and has no CPU fallback', file=sys.stderr)
        return 1
    print('bench device: %s' % torch.cuda.get_device_name(0),
          file=sys.stderr)
    res = run(torch.device('cuda', 0))
    res.pop('detail')
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
