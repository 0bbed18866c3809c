"""Probe of the integrator's batched LU (``csrc/batched_lu.cu``) on one
CUDA card, beside the library paths it replaced or could have.

What it does, at the integrate cell's shape (the 53-species flagship,
B = 32768): K4 (``DenseJacobian``) computes the stage Jacobians of PaSR
flagship states (the 4032 of ``tests/data/flagship_states.npz``, tiled),
each state takes a step scale s = h gamma drawn log-uniform over [1e-11,
3e-5] (seeded, as ``chip_smoke.py`` phase 11e, which checks the kernels
against the library on the same W), and it times, with CUDA events
(median of ``REPS``, two turns):

* the kernels: the factor (J read where K4 leaves it, and from a
  contiguous (B, N, N) copy), the solve, and an iteration's LU as the
  integrator runs it (one factor, three solves);
* the library under each backend ``torch.backends.cuda.
  preferred_linalg_library`` offers for this batch: ``default`` (MAGMA's
  batched getrf, the port's path before the kernels) and ``cusolver``
  (cuBLAS's getrfBatched / getrsBatched): the factor of W, a solve, and
  the iteration (W formed in torch, ``lu_factor_ex``, three
  ``lu_solve``), with each backend's pivots against the kernel's;
* W's formation alone; each beside its byte bound at 3.35 TB/s.

It prints the card's ``nvidia-smi`` line, ptxas's lines for the two
kernels, a line per turn and one JSON line of them all.  Run it from a
checkout's root: ``python3 probes/batched_lu.py``.
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

REPS = 7
HBM = 3.35e12
OPS = torch.ops.pyjac_tpu_torch
BACKENDS = ('default', 'cusolver')


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()


def ms(fn) -> float:
    """Median ms of ``fn()`` over REPS, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def stage(B, card):
    """K4's Jt (N, N, B) at B tiled PaSR states, and the scales s."""
    _, p = flagship()
    d = np.load(os.path.join('tests', 'data', 'flagship_states.npz'))
    idx = np.arange(B) % len(d['y'])
    y_t = torch.as_tensor(d['y'][idx].T.copy(), device=card)
    P_t = torch.as_tensor(d['P'][None, idx].copy(), device=card)
    Jt, _ = DenseJacobian(p, device=card).call_tr(y_t, P_t)
    rng = np.random.default_rng(17)
    s = torch.as_tensor(10.0 ** rng.uniform(-11, np.log10(3e-5), B),
                        device=card)
    return Jt, s


def timings(Jt, s, card) -> dict:
    N, B = Jt.shape[0], Jt.shape[-1]
    Jd = Jt.permute(2, 1, 0)
    rhs = torch.randn((B, N), dtype=Jt.dtype, device=card)
    LU, piv, _ = OPS.lu_factor(Jd, s)
    eye = torch.eye(N, dtype=Jt.dtype, device=card)
    W = eye - s[:, None, None] * Jd

    def kernel_iter():
        f = OPS.lu_factor(Jd, s)
        for _ in range(3):
            OPS.lu_solve(f[0], f[1], rhs)

    def library_iter():
        Wi = eye - s[:, None, None] * Jd
        lu, pv, _ = torch.linalg.lu_factor_ex(Wi, check_errors=False)
        for _ in range(3):
            torch.linalg.lu_solve(lu, pv, rhs[..., None])

    t = {'factor': ms(lambda: OPS.lu_factor(Jd, s)),
         'factor_xla_layout': ms(lambda: OPS.lu_factor(Jd.contiguous(), s)),
         'solve': ms(lambda: OPS.lu_solve(LU, piv, rhs)),
         'kernel_iter': ms(kernel_iter),
         'form_W': ms(lambda: eye - s[:, None, None] * Jd)}
    for backend in BACKENDS:
        torch.backends.cuda.preferred_linalg_library(backend)
        try:
            LUr, pivr, _ = torch.linalg.lu_factor_ex(W, check_errors=False)
            t[backend + '_states_pivots_differ'] = int(
                (pivr != piv).any(-1).sum())
            t[backend + '_factor'] = ms(
                lambda: torch.linalg.lu_factor_ex(W, check_errors=False))
            t[backend + '_solve'] = ms(
                lambda: torch.linalg.lu_solve(LUr, pivr, rhs[..., None]))
            t[backend + '_iter'] = ms(library_iter)
        finally:
            torch.backends.cuda.preferred_linalg_library('default')
    byte = N * N * B * 8
    t['bound_factor'] = 2 * byte / HBM * 1e3
    t['bound_solve'] = (byte + 2 * N * B * 8 + N * B * 4) / HBM * 1e3
    t['bound_iter'] = t['bound_factor'] + 3 * t['bound_solve']
    return t


def main():
    card = torch.device('cuda', 0)
    print(card_line())
    print('planner: LU_MAX_N %d, tile at N = 53: %d'
          % (kernels.LU_MAX_N, kernels.lu_tile(53)))
    out = {'card': card_line()}
    Jt, s = stage(32768, card)
    lines = kernels.build_info.get('log', '').splitlines()
    for i, line in enumerate(lines):
        if 'lu_factor_kernel' in line or 'lu_solve_kernel' in line:
            for extra in lines[i:i + 4]:
                print('  ptxas:', extra.strip())
    for turn in (1, 2):
        t = timings(Jt, s, card)
        out['turn%d' % turn] = t
        print('turn %d (ms, B = 32768): ' % turn + ', '.join(
            '%s %.4f' % kv for kv in t.items()))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
