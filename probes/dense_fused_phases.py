"""Probe of the dense fused kernels K4 (float64) and K3 (float32) on one
CUDA card: where their time goes, phase by phase.

What it builds, from this checkout's sources into ``build/probes/``:
``probes/dense_fused_phases.cu``, which includes
``pyjac_tpu_torch/csrc/dense_fused.cu`` and instantiates its kernel
template cut after phase LAST = 1 (state and thermo), 2 (+ reaction
parts), 3 (+ stoichiometric contractions), 4 (+ closure) and 5 (+ the
columns: the launcher's kernel), each on the launcher's arguments.

What it measures: each cut at K4's timed shape (the 53-species /
325-reaction flagship's PaSR states tiled to B = 32768, CONP) and at
K3's (the f32 cell: ``random_states(seed=1, T_range=(1500, 2500))``,
B = 262144), as ms per call (10 queued, best of 3, CUDA events) in two
turns beside the launcher, after checking the cut at 5 bit-equal to
the launcher's J and f; then the launcher under the plans of ``TILES``
(tiles and placements: ``kernels.tile_plan``), each checked
bit-equal to the planner's choice (a state's arithmetic does not depend
on its tile).  It prints
the card's ``nvidia-smi`` line first and last and ptxas's registers and
spills for each instantiation.  It is not part of ``chip_smoke.py``.

Run from the repository root: ``python3 probes/dense_fused_phases.py``.
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
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import flagship  # noqa: E402

PHASES = ('state + thermo', 'reaction parts', 'contractions', 'closure',
          'columns')
# the other plans timed beside the planner's: (states per tile,
# placement) per type
TILES = {torch.float64: ((8, 'shared'), (4, 'shared'), (4, 'global')),
         torch.float32: ((16, 'shared'), (8, 'shared'), (8, 'global'))}


def build():
    """The cuts' library and ptxas's report: {function: (registers,
    spill stores + loads in bytes)}."""
    out = os.path.join(ROOT, 'build', 'probes')
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, 'libdense_fused_phases.so')
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-shared',
                          '-o', lib,
                          os.path.join(HERE, 'dense_fused_phases.cu')],
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
    base = kernels.load().pyjac_dense_fused.argtypes
    for fn in (dll.dfp_f64, dll.dfp_f32):
        fn.argtypes = [ctypes.c_int] + list(base)
        fn.restype = ctypes.c_int
    for fn in (dll.dfp_store_f64, dll.dfp_store_f32):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return dll, report


# J's store pattern alone (dfp_store_*): (states a tile, threads, shared
# bytes held a block) per type; 32 states a block of 128 threads is the
# first design's pattern (a warp's 32 lanes on 32 consecutive states)
STORES = {torch.float64: ((4, 512, 128160), (7, 512, 224280),
                          (8, 512, 128160), (16, 512, 128160),
                          (32, 128, 0)),
          torch.float32: ((8, 512, 128160), (14, 512, 224280),
                          (16, 512, 128160), (32, 512, 128160),
                          (32, 128, 0))}


def store_patterns(dll, N, B, dtype, card):
    """ms per call of J's store pattern alone at each of STORES."""
    fn = dll.dfp_store_f64 if dtype == torch.float64 else dll.dfp_store_f32
    Jt = torch.empty((N, N, B), dtype=dtype, device='cuda')
    stream = torch.cuda.current_stream().cuda_stream
    print('J store pattern alone, N=%d, B=%d, %s (%s):' % (N, B, dtype, card))
    for tile, threads, smem in STORES[dtype]:
        ms = cs.per_call_ms(lambda: cs.check(
            fn(Jt.data_ptr(), B, N, tile, threads, smem, stream) == 0,
            'store pattern launch'))
        print('  %2d states a block, %3d threads, %6d B shared: %.3f ms = '
              '%.3f TB/s' % (tile, threads, smem, ms,
                             Jt.numel() * Jt.element_size() / ms / 1e9))


def cut_call(fn, last, mod, y_t, P_t, dtype, plan):
    """The kernel cut after phase ``last`` on the launcher's arguments
    under ``plan``: its (Jt, f)."""
    _, args, (Jt, f), keep = kernels.tile_args(
        'dense_fused' if dtype == torch.float64 else 'fused_f32',
        *kernels.dense_inputs(mod, dtype), y_t, P_t, kernels.plan_ints(plan))
    err = fn(last, *args)
    cs.check(err == 0, 'cut %d: CUDA error %d' % (last, err))
    del keep
    return Jt, f


def case(name, dll, fn, launcher, mod, y_t, P_t, dtype, card):
    B = y_t.shape[-1]
    plan = kernels.tile_plan(mod, dtype, B)
    ref = launcher(mod, y_t, P_t)
    got = cut_call(fn, 5, mod, y_t, P_t, dtype, plan)
    torch.cuda.synchronize()
    cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
             '%s: the cut at 5 differs from the launcher' % name)
    del got, ref
    n = 10 if dtype == torch.float64 else 5
    times = {}
    for turn in (0, 1):
        times.setdefault('launcher', []).append(cs.per_call_ms(
            lambda: launcher(mod, y_t, P_t), n=n))
        for last in range(1, 6):
            times.setdefault(last, []).append(cs.per_call_ms(
                lambda: cut_call(fn, last, mod, y_t, P_t, dtype, plan), n=n))
    print('%s, B=%d, ms per call (two turns; %s; cuts at %d states a tile, '
          '%s):' % (name, B, card, plan['tile'], plan['placement']))
    print('  launcher           %s' % ' / '.join(
        '%.3f' % t for t in times['launcher']))
    prev = 0.0
    for last in range(1, 6):
        best = min(times[last])
        print('  cut %d %-14s %s  (+%.3f)' % (
            last, PHASES[last - 1], ' / '.join('%.3f' % t
                                               for t in times[last]),
            best - prev))
        prev = best
    plan_fn = kernels.tile_plan
    chosen = plan_fn(mod, dtype, B)
    ref = launcher(mod, y_t, P_t)
    print('  planner: %s' % (chosen,))
    for tile, placement in TILES[dtype]:
        plan = plan_fn(mod, dtype, B, tile=tile, placement=placement)
        got = launcher(mod, y_t, P_t, plan=plan)
        torch.cuda.synchronize()
        cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                 '%s: plan %s differs from the planner\'s' % (name, plan))
        del got
        ms = [cs.per_call_ms(lambda: launcher(mod, y_t, P_t, plan=plan),
                             n=n) for _ in (0, 1)]
        print('  tile %2d %-6s %5d blocks: %s' % (
            tile, placement, plan['grid'], ' / '.join('%.3f' % t for t in ms)))
    del ref


def main():
    cs.check(torch.cuda.is_available(), 'no CUDA device available')
    card = cs.smi_line()
    print(card)
    dev = torch.device('cuda', 0)
    kernels.load()
    dll, report = build()
    for name, (regs, spill) in sorted(report.items()):
        print('  ptxas: %s %d registers, %d bytes spilled' % (name, regs,
                                                              spill))
    _, packed = flagship()
    store_patterns(dll, packed.n_species, 32768, torch.float64, card)
    store_patterns(dll, packed.n_species, 262144, torch.float32, card)
    y_t, P_t = cs.to_tr(*cs.flagship_states(32768), dev)
    case('K4 flagship', dll, dll.dfp_f64, kernels.dense_fused,
         DenseJacobian(packed, device=dev), y_t, P_t, torch.float64, card)
    del y_t, P_t
    torch.cuda.empty_cache()
    y_t, P_t = cs.f32_states(packed, 262144, dev)
    case('K3 f32 cell', dll, dll.dfp_f32, kernels.fused_f32,
         F32Jacobian(packed, device=dev), y_t, P_t, torch.float32, card)
    print(cs.smi_line())
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except cs.Fail as e:
        print('dense_fused_phases FAILED: %s' % e, file=sys.stderr)
        sys.exit(1)
