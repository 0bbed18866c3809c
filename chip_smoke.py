"""On-card smoke run of the PyTorch + CUDA port (``pyjac_tpu_torch``).

Drives the port's main path — the flagship 53-species / 325-reaction
mechanism's analytical Jacobian + dy/dt through ``SparseJacobian`` —
on one CUDA card, in phases; any failure exits non-zero at once:

1. device: a CUDA card is required; prints its ``nvidia-smi`` name and
   power limit;
2. build: compiles the two kernels of ``pyjac_tpu_torch/csrc`` with
   nvcc and loads them;
3. kernels vs plain: each kernel against its plain PyTorch version on
   the same 16384 flagship states (and stage A also under CONV);
4. golden: the 128 reference-C golden states of
   ``tests/data/golden_flagship_refc.npz``;
5. main path: the flagship states tiled to B = 131072 through
   ``SparseJacobian.call_tr`` (one warm-up, best of 3 timed passes with
   CUDA events), with both kernels' launch counters checked, then each
   stage timed alone against its plain version at the same B.

The last three lines of standard output are one JSON object with a
row per kernel, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.  Without a
CUDA card it exits non-zero and prints no result.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from pyjac_tpu_torch.core.constants import RU  # noqa: E402
from pyjac_tpu_torch.ops import kernels  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_sparse import (  # noqa: E402
    SparseJacobian, post_rows, stage_a_reference, stage_b_reference)
from pyjac_tpu_torch.testers.synthetic import flagship  # noqa: E402

F64 = torch.float64
DATA = os.path.join(HERE, 'tests', 'data')

# tolerances (kernel vs plain version on the card: the kernels sum in
# another order than torch's reductions and matmuls, so not bit-exact)
TOL_ELEMENTWISE = 1e-12   # rows without a stoichiometric or net-rate sum,
#                           per-row norm-relative
TOL_NET = 1e-8            # arrays that sum net rates, norm-relative per
#                           state (the repo's dy/dt metric): PaSR states sit
#                           near equilibrium, where net rates cancel to ~1e-9
#                           of the gross fluxes and magnify roundoff
# bounds set from readings on an H100 (NVIDIA H100 80GB HBM3, 700 W) at
# 16384 flagship states, CONP and CONV:
TOL_PSI_Q = 1e-9          # third-body source rows psi*(Rf - Rr)*eff carry a
#                           net rate; per row, read 1.8e-10
TOL_F_ROW = 1e-7          # dy/dt species rows, each on its own scale, read
#                           2.4e-8 (cause not isolated, see PERF.md)
TOL_J = 1e-9             # Jacobian columns, floored at 1e-10 of the state
# golden parity (tests/test_golden_parity.py:255-274)
TOL_GOLDEN_J = 1e-8
TOL_GOLDEN_F = 1e-7


class Fail(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise Fail(msg)


def row_rel(a, b):
    """max over rows of max|a-b| / max|b| along the batch axis (-1)."""
    err = (a - b).abs().amax(dim=-1)
    scale = b.abs().amax(dim=-1).clamp_min(1e-300)
    return float((err / scale).max())


def state_rel(a, b):
    """max over states of max|a-b| / max|b| over the array's rows (-2);
    a one-row array normalizes over the batch instead."""
    if a.shape[0] == 1:
        return row_rel(a, b)
    err = (a - b).abs().amax(dim=0)
    scale = b.abs().amax(dim=0).clamp_min(1e-300)
    return float((err / scale).max())


def floored(a, b, floor):
    """Per-state floored relative error of (..., B) arrays: entries
    below ``floor`` x the state's largest entry compare on that scale."""
    bmax = b.abs().reshape(-1, b.shape[-1]).amax(dim=0)
    denom = torch.maximum(b.abs(), bmax * floor + 1e-300)
    return float(((a - b).abs() / denom).max())


def flagship_states(B):
    d = np.load(os.path.join(DATA, 'flagship_states.npz'))
    reps = -(-B // len(d['y']))
    return np.tile(d['y'], (reps, 1))[:B], np.tile(d['P'], reps)[:B]


def to_tr(y, P, device):
    y_t = torch.as_tensor(y.T.copy(), dtype=F64, device=device)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), dtype=F64,
                          device=device)
    return y_t, P_t


def best_ms(fn, reps=3, warm=1):
    """Best of ``reps`` timed calls of ``fn`` in ms, CUDA events, after
    ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return min(times)


def smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, 'nvidia-smi failed: %s' % out.stderr)
    return out.stdout.strip().splitlines()[0]


def phase_kernels_vs_plain(sj, packed, device, B, card):
    """Phase 3: K1 and K2 against their plain versions, same inputs."""
    y, P = flagship_states(B)
    y_t, P_t = to_tr(y, P, device)
    N, R, J = sj.N, sj.R, sj.J
    rows = post_rows(N, J)
    summed = ('v_u', 'v_c', 'fkJ', 'fT')
    res = {}
    for conp in (True, False):
        if not conp:
            sj = SparseJacobian(packed, conp=False, device=device)
        if conp:
            param = P_t
        else:
            # CONV takes density: the state's own, so the rates stay real
            inv_mw = torch.as_tensor(packed.inv_mw, device=device)
            Yf = torch.cat([y_t[1:], 1.0 - y_t[1:].sum(0, keepdim=True)])
            param = (P_t / (RU * y_t[:1] * (Yf * inv_mw[:, None]).sum(
                0, keepdim=True))).contiguous()
        ref = stage_a_reference(packed, y_t, param, conp)
        got = sj.stage_a(y_t, param)
        torch.cuda.synchronize()
        errs = {}
        # source stack: per-slot values are elementwise; the third-body
        # rows psi*(Rf - Rr)*eff carry a net rate of progress
        n_vals = (sj.Sf + sj.Sp) * R
        errs['src_vals'] = (row_rel(got['src'][:n_vals], ref['src'][:n_vals]),
                            TOL_ELEMENTWISE)
        if sj.S_eff:
            a, b = n_vals, n_vals + sj.S_eff * R
            errs['src_psi_q'] = (row_rel(got['src'][a:b], ref['src'][a:b]),
                                 TOL_PSI_Q)
        rest = got['src'][n_vals + sj.S_eff * R:]
        errs['src_zero_rows'] = (float(rest.abs().max()), 0.0)
        # the temperature row (0) of col0 and f is far larger than the
        # species rows, so each part is gated on its own scale
        for k in ('col0', 'f'):
            errs[k + ' T'] = (row_rel(got[k][:1], ref[k][:1]), TOL_NET)
            errs[k + ' Y'] = (state_rel(got[k][1:], ref[k][1:]), TOL_NET)
        errs['f Y per row'] = (row_rel(got['f'][1:], ref['f'][1:]), TOL_F_ROW)
        for name, (a, b) in rows.items():
            ga, ra = got['post'][a:b], ref['post'][a:b]
            errs[name] = ((state_rel(ga, ra), TOL_NET) if name in summed
                          else (row_rel(ga, ra), TOL_ELEMENTWISE))
        tag = 'conp' if conp else 'conv'
        for name, (err, tol) in errs.items():
            print('  stage A %s %-13s %.3e (<= %.0e)' % (tag, name, err, tol))
        for name, (err, tol) in errs.items():
            check(err <= tol, 'stage A %s %s: %.3e > %.0e' % (tag, name, err,
                                                               tol))
        max_a = max(float((got[k] - ref[k]).abs().max())
                    for k in ('src', 'col0', 'f', 'post'))
        cref = stage_b_reference(sj.gidx, sj.nuc, sj.inv_mw, ref['src'],
                                 ref['post'], conp)
        cgot = sj.stage_b(ref['src'], ref['post'])
        torch.cuda.synchronize()
        errJ = floored(cgot, cref, 1e-10)
        print('  stage B %s J floored@1e-10 %.3e (<= %.0e)' % (tag, errJ,
                                                               TOL_J))
        check(errJ <= TOL_J, 'stage B %s: %.3e > %.0e' % (tag, errJ, TOL_J))
        if conp:
            res = dict(stage_a=max_a,
                       stage_b=float((cgot - cref).abs().max()))
        del ref, got, cref, cgot
    print('phase 3 kernels vs plain: ok (B=%d, %s)' % (B, card))
    return res


def phase_golden(sj, device, card):
    """Phase 4: the 128 reference-C golden states through the module."""
    g = np.load(os.path.join(DATA, 'golden_flagship_refc.npz'))
    J, f = sj(torch.as_tensor(g['y'], device=device),
              torch.as_tensor(g['P'], device=device))
    n = len(g['T'])
    Jl = J.cpu().numpy().transpose(0, 2, 1).reshape(n, -1)
    ref = g['ref_jac']
    denom = np.maximum(np.abs(ref),
                       np.abs(ref).max(-1, keepdims=True) * 1e-10 + 1e-300)
    errJ = float((np.abs(Jl - ref) / denom).max())
    fr = g['ref_dydt']
    errf = float((np.abs(f.cpu().numpy() - fr).max(-1) /
                  np.abs(fr).max(-1)).max())
    print('phase 4 golden: J floored@1e-10 %.3e (< %.0e), dy/dt norm-rel '
          '%.3e (< %.0e) (%s)' % (errJ, TOL_GOLDEN_J, errf, TOL_GOLDEN_F,
                                  card))
    check(np.all(np.isfinite(Jl)) and np.all(np.isfinite(f.cpu().numpy())),
          'golden: non-finite output')
    check(errJ < TOL_GOLDEN_J, 'golden J %.3e' % errJ)
    check(errf < TOL_GOLDEN_F, 'golden dy/dt %.3e' % errf)


def phase_main(sj, packed, device, B, card):
    """Phase 5: the main path at bench size, then each stage alone."""
    y, P = flagship_states(B)
    y_t, P_t = to_tr(y, P, device)
    sums = {}

    def one_pass():
        out = sj.call_tr(y_t, P_t)
        sums['chk'] = [torch.sum(x) for x in out]

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    total_ms = best_ms(one_pass, reps=3, warm=1)
    counts = dict(kernels.launches)
    chk = [float(c) for c in sums['chk']]
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    print('phase 5 main path: B=%d, best of 3 %.3f ms = %.0f evals/s, '
          'checksums %s, peak %.2f GiB, launches %s (%s)' % (
              B, total_ms, B / (total_ms * 1e-3), ['%.6e' % c for c in chk],
              peak, counts, card))
    check(all(math.isfinite(c) for c in chk), 'non-finite checksum')
    check(counts['stage_a'] > 0 and counts['stage_b'] > 0,
          'main path did not launch both kernels: %s' % counts)

    # each stage alone, kernel and plain version, at the same B
    a = sj.stage_a(y_t, P_t)
    ms = {}
    ms['stage_a'] = best_ms(lambda: sj.stage_a(y_t, P_t))
    ms['stage_b'] = best_ms(lambda: sj.stage_b(a['src'], a['post']))
    ms['stage_a_plain'] = best_ms(
        lambda: stage_a_reference(packed, y_t, P_t, True), reps=2)
    ms['stage_b_plain'] = best_ms(
        lambda: stage_b_reference(sj.gidx, sj.nuc, sj.inv_mw, a['src'],
                                  a['post'], True), reps=2)
    for k in ('stage_a', 'stage_b'):
        print('  %s: kernel %.3f ms, plain version %.3f ms (B=%d, %s)'
              % (k, ms[k], ms[k + '_plain'], B, card))
    return dict(counts=counts, ms=ms, total_ms=total_ms)


def main():
    # --- phase 1: device -----------------------------------------------------
    check(torch.cuda.is_available(), 'no CUDA device available')
    device = torch.device('cuda', 0)
    card = smi_line()
    print('phase 1 device: %s; torch %s, CUDA %s' % (
        card, torch.__version__, torch.version.cuda))
    # --- phase 2: build ------------------------------------------------------
    kernels.load()
    print('phase 2 build: %.1f s -> %s' % (
        kernels.build_info['seconds'], kernels.build_info['library']))
    for line in kernels.build_info['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas: ' + line.strip())

    mech, packed = flagship()
    sj = SparseJacobian(packed, device=device)
    errs = phase_kernels_vs_plain(sj, packed, device, 16384, card)
    phase_golden(sj, device, card)
    main_res = phase_main(sj, packed, device, 131072, card)

    rows = []
    for name, src, line in (
            ('stage_a', 'pyjac_tpu_torch/csrc/sparse_stage_a.cu',
             'pyjac_tpu/ops/pallas_dd.py:2099'),
            ('stage_b', 'pyjac_tpu_torch/csrc/sparse_stage_b.cu',
             'pyjac_tpu/ops/pallas_dd.py:2204')):
        rows.append(dict(name=name, route='cuda', source=src, replaces=line,
                         launches=main_res['counts'][name],
                         max_abs_err=errs[name], ms=main_res['ms'][name],
                         plain_ms=main_res['ms'][name + '_plain']))
    print(json.dumps({'kernels': rows}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Fail as e:
        print('chip_smoke FAILED: %s' % e, file=sys.stderr)
        sys.exit(1)
