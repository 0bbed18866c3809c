"""Probe of the stage-A kernel K1 and the reaction-parts kernel K5 on one
CUDA card: where K1's time goes, phase by phase, and each kernel beside
the version it had before its redesign, in one call.

What it builds, from this checkout's sources into ``build/probes/``:
``probes/stage_a_phases.cu``, which includes
``pyjac_tpu_torch/csrc/sparse_stage_a.cu`` and instantiates its kernel
template cut after phase LAST = 1 (state and thermo), 2 (+ reaction
parts and source rows), 3 (+ contractions), 4 (+ closure) and 5 (+ the
post rows out: the launcher's kernel), each on the launcher's arguments;
beside it the parent K1 (32 states a block, a global scratch, run-time
slot counts, the closure on one warp) cut after its phases 1-4, and the
parent K5 (run-time slot counts).

What it measures, as ms per call (10 queued, best of 3, CUDA events) in
two turns: at the 53-species / 325-reaction flagship (its PaSR states
tiled to B = 131072) and the 53/326 all-features synth
(``random_states(seed=3)``, B = 131072), CONP, the launcher's K1 and its
cuts beside the parent's K1 and its cuts, after checking the launcher's
src, col0, f and post bit-equal to the cut at 5 and to the parent's;
then the launcher under the other tiles of ``TILES`` and the global
placement (``kernels.tile_plan``), each checked bit-equal.  At the 654
class: K1 at B = 1024 under the planner's tile (one state in shared
memory) and the global placement, checked bit-equal.  The parent K5
beside ``BigJacobian.parts`` (both reaction ranges of the pres-mod
split), checked bit-equal, at the flagship and the synth (B = 131072)
and the 654 class (B = 1024).  It prints the card's ``nvidia-smi`` line
first and last and ptxas's registers and spills for each
instantiation.  It is not part of ``chip_smoke.py``.

Run from the repository root: ``python3 probes/stage_a_phases.py``.
"""

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pyjac_tpu_torch.ops import kernels  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_big import (  # noqa: E402
    BigJacobian, state_thermo)
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian  # noqa: E402
from pyjac_tpu_torch.ops.rates import _LN_PA_RU  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import (  # noqa: E402
    flagship, packed_from_text, plausible_mechanism, synthetic_mechanism)

B = 131072
B_654 = 1024
PHASES = ('state + thermo', 'parts + src', 'contractions', 'closure',
          'post out')
OUTS = ('src', 'col0', 'f', 'post')
F64 = torch.float64
# the other tiles timed beside the planner's (states per tile, placement)
TILES = {'flagship': ((4, 'shared'), (12, 'shared'), (None, 'global')),
         'synth53': ((4, 'shared'), (None, 'global'))}


def build():
    """The probe's library and ptxas's report: {function: (registers,
    spill stores + loads in bytes)}."""
    out = os.path.join(ROOT, 'build', 'probes')
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, 'libstage_a_phases.so')
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-shared',
                          '-o', lib, os.path.join(HERE, 'stage_a_phases.cu')],
                         capture_output=True, text=True)
    cs.check(res.returncode == 0, 'nvcc failed:\n%s' % res.stdout[-4000:] +
             res.stderr[-4000:])
    report, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line) or \
            re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and name:
            regs, _ = report.get(name, (0, 0))
            report[name] = (regs, int(m.group(1)) + int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            report[name] = (int(m.group(1)), report.get(name, (0, 0))[1])
    dll = ctypes.CDLL(lib)
    vp, ci, cd, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
    dll.sap_parent_scratch_rows.argtypes = [vp]
    dll.sap_parent_scratch_rows.restype = cll
    dll.sap_parent_k1.argtypes = [ci, vp, vp, cd, vp, vp, cll] + [vp] * 6
    dll.sap_parent_k1.restype = ci
    lib = kernels.load()
    dll.sap_parent_parts.argtypes = lib.pyjac_big_parts.argtypes
    dll.sap_parent_parts.restype = ci
    dll.sap_k1.argtypes = [ci] + list(lib.pyjac_stage_a.argtypes)
    dll.sap_k1.restype = ci
    return dll, report


def k1_tables(sj):
    """K1's table pointers and dims of ``sj`` (its launcher's)."""
    tabs, dims = kernels.stage_a_inputs(sj)
    ptrs = kernels.table_ptrs(tabs, F64, sj.device, 'K1')
    return ptrs, (ctypes.c_int * 12)(*dims[:12])


def parent_k1(dll, last, sj, y_t, P_t, keep):
    """The parent K1 cut after phase ``last``: its (src, col0, f, post)."""
    ptrs, cdims = keep.setdefault('k1', k1_tables(sj))
    n = y_t.shape[-1]
    outs = [torch.empty((rows, n), dtype=F64, device=y_t.device)
            for rows in (sj.n_src, sj.N, sj.N, sj.n_post)]
    scratch = torch.empty((dll.sap_parent_scratch_rows(cdims), n), dtype=F64,
                          device=y_t.device)
    err = dll.sap_parent_k1(last, ptrs, cdims, _LN_PA_RU, y_t.data_ptr(),
                            P_t.data_ptr(), n, *[o.data_ptr() for o in outs],
                            scratch.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, 'parent K1 cut %d: CUDA error %d' % (last, err))
    return dict(zip(OUTS, outs))


def cut_k1(dll, last, sj, y_t, P_t, plan=None):
    """The launcher's K1 cut after phase ``last`` under ``plan``: its
    outputs."""
    _, args, out, keep = kernels.tile_args(
        'stage_a', *kernels.stage_a_inputs(sj), y_t, P_t,
        kernels.plan_ints(plan))
    err = dll.sap_k1(last, *args)
    cs.check(err == 0, 'K1 cut %d: CUDA error %d' % (last, err))
    del keep
    return dict(zip(OUTS, out))


def same(a, b):
    return all(torch.equal(a[k], b[k]) for k in OUTS)


def times(fns, n=10):
    """{name: [ms per call, two turns]} of each fn, in turns."""
    out = {}
    for _ in (0, 1):
        for name, fn in fns:
            out.setdefault(name, []).append(cs.per_call_ms(fn, n=n))
    return out


def fmt(ts):
    return ' / '.join('%.3f' % t for t in ts)


def print_split(t, prefix, cuts):
    prev = 0.0
    for c in cuts:
        best = min(t['%s %d' % (prefix, c)])
        print('  %-6s %d %-14s %s  (+%.3f)' % (
            prefix, c, PHASES[c - 1], fmt(t['%s %d' % (prefix, c)]),
            best - prev))
        prev = best


def k1_case(name, packed, dll, card):
    dev = torch.device('cuda', 0)
    y_t, P_t = cs.case_states(name, packed, B, dev)
    sj = SparseJacobian(packed, device=dev)
    keep = {}
    plan = kernels.tile_plan(sj, F64, B, kernels._n_sm(dev))
    ref = kernels.stage_a(sj, y_t, P_t)
    for what, got in (('the cut at 5', cut_k1(dll, 5, sj, y_t, P_t)),
                      ('the parent K1', parent_k1(dll, 4, sj, y_t, P_t,
                                                  keep))):
        torch.cuda.synchronize()
        cs.check(same(got, ref), '%s: %s differs from the launcher'
                 % (name, what))
        del got
    torch.cuda.empty_cache()
    fns = [('launcher', lambda: kernels.stage_a(sj, y_t, P_t))]
    fns += [('cut %d' % c, lambda c=c: cut_k1(dll, c, sj, y_t, P_t))
            for c in range(1, 6)]
    fns += [('parent %d' % c,
             lambda c=c: parent_k1(dll, c, sj, y_t, P_t, keep))
            for c in range(1, 5)]
    t = times(fns)
    print('%s K1, B=%d, ms per call (two turns; %s; cuts at %d states a '
          'tile, %s):' % (name, B, card, plan['tile'], plan['placement']))
    print('  launcher K1           %s' % fmt(t['launcher']))
    print_split(t, 'cut', range(1, 6))
    print_split(t, 'parent', range(1, 5))
    print('  planner: %s' % (plan,))
    for tile, placement in TILES[name]:
        other = kernels.tile_plan(sj, F64, B, kernels._n_sm(dev), tile=tile,
                                  placement=placement)
        got = kernels.stage_a(sj, y_t, P_t, plan=other)
        torch.cuda.synchronize()
        cs.check(same(got, ref), '%s: plan %s differs from the planner\'s'
                 % (name, other))
        del got
        ms = [cs.per_call_ms(lambda: kernels.stage_a(sj, y_t, P_t,
                                                     plan=other))
              for _ in (0, 1)]
        print('  tile %2d %-6s %6d blocks: %s' % (
            other['tile'], placement, other['grid'], fmt(ms)))
    del sj, y_t, P_t, ref
    torch.cuda.empty_cache()


def k1_654(p654, card):
    """K1 at the 654 class under the planner's tile (one state in shared
    memory) and the global placement: bit-equal, and their times."""
    dev = torch.device('cuda', 0)
    y_t, P_t = cs.big_states(p654, B_654, dev)
    sj = SparseJacobian(p654, device=dev)
    plans = [kernels.tile_plan(sj, F64, B_654, kernels._n_sm(dev)),
             kernels.tile_plan(sj, F64, B_654, kernels._n_sm(dev),
                               placement='global')]
    ref = kernels.stage_a(sj, y_t, P_t, plan=plans[0])
    got = kernels.stage_a(sj, y_t, P_t, plan=plans[1])
    torch.cuda.synchronize()
    cs.check(same(got, ref), '654 class: the global slices differ from the '
             'shared tile')
    del got, ref
    print('654 class K1, B=%d, ms per call (two turns; %s):' % (B_654, card))
    for plan in plans:
        ms = [cs.per_call_ms(lambda: kernels.stage_a(sj, y_t, P_t, plan=plan))
              for _ in (0, 1)]
        print('  tile %d %-6s %4d blocks: %s' % (
            plan['tile'], plan['placement'], plan['grid'], fmt(ms)))
    del sj, y_t, P_t
    torch.cuda.empty_cache()


def k5_case(dll, name, packed, B_k5, card):
    """The parent K5 beside ``BigJacobian.parts`` (both reaction ranges
    of the pres-mod split) on ``packed``'s states: bit-equal, and their
    times."""
    dev = torch.device('cuda', 0)
    y_t, P_t = cs.case_states(name, packed, B_k5, dev)
    bj = BigJacobian(packed, device=dev)
    st = state_thermo(bj.packed, y_t, P_t, True)
    p = bj.packed
    tabs, dims = kernels.parts_inputs(bj)
    cdims = (ctypes.c_int * len(dims))(*dims)
    n_tabs, ptrs = len(tabs), kernels.table_ptrs(tabs, F64, dev, 'K5')
    pieces = (((0, bj.split_r1, 1), (bj.split_r1, bj.R - bj.split_r1, 0))
              if bj.split_r1 else ((0, bj.R, int(p.has_pres_mod)),))

    def parent():
        roles = torch.empty((bj.n_roles, bj.R, B_k5), dtype=F64, device=dev)
        for row0, rows, pm in pieces:
            err = dll.sap_parent_parts(
                ptrs, n_tabs, cdims, len(dims), _LN_PA_RU,
                ctypes.c_void_p(st['rows'].data_ptr()), B_k5, row0, rows, pm,
                ctypes.c_void_p(roles.data_ptr()),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            cs.check(err == 0, 'parent K5: CUDA error %d' % err)
        return roles

    got, ref = parent(), bj.parts(st)
    torch.cuda.synchronize()
    cs.check(torch.equal(got, ref), '%s: the parent K5 differs from the '
             'launcher' % name)
    del got, ref
    t = times([('launcher', lambda: bj.parts(st)), ('parent', parent)])
    print('%s K5 (Sf %d, Sp %d), B=%d, ms per call (two turns; %s):'
          % (name, bj.Sf, bj.Sp, B_k5, card))
    print('  launcher K5  %s' % fmt(t['launcher']))
    print('  parent K5    %s' % fmt(t['parent']))
    del bj, st, y_t, P_t
    torch.cuda.empty_cache()


def main():
    cs.check(torch.cuda.is_available(), 'no CUDA device available')
    card = cs.smi_line()
    print(card)
    kernels.load()
    dll, report = build()
    for name, (regs, spill) in sorted(report.items()):
        print('  ptxas: %s %d registers, %d bytes spilled' % (name, regs,
                                                              spill))
    cases = (('flagship', flagship()[1]),
             ('synth53', packed_from_text(synthetic_mechanism(
                 53, 325, seed=7))[1]))
    for name, packed in cases:
        k1_case(name, packed, dll, card)
    p654 = packed_from_text(plausible_mechanism(654, 2716, seed=5))[1]
    k1_654(p654, card)
    for name, packed in cases:
        k5_case(dll, name, packed, B, card)
    k5_case(dll, '654', p654, B_654, card)
    print(cs.smi_line())
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except cs.Fail as e:
        print('stage_a_phases FAILED: %s' % e, file=sys.stderr)
        sys.exit(1)
