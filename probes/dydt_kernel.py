"""Probe of the dy/dt kernel (``csrc/dydt.cu``) on one CUDA card.

What it builds, from this checkout's sources into ``build/probes/``:
``probes/dydt_kernel.cu``, which includes
``pyjac_tpu_torch/csrc/dense_fused.cu`` and instantiates K4 cut after
its phase 4 (``launch<double, 4>``: the phases the dy/dt kernel runs,
with K4's derivative roles and post rows, without the columns).

What it measures, at the integrate cell's shape (the 53-species /
325-reaction flagship's PaSR states tiled to B = 32768, CONP), in two
turns, ms per call (10 queued, best of 3, CUDA events): the dy/dt
kernel on the integrator's (B, N) states (their (N, B) transposed view)
and on (N, B) states, under the planner's tile and under the plans of
``TILES`` (each checked bit-equal to K4's f); K4; K4 cut after phase 4;
the plain ``ops/dydt.py``.  It prints the card's ``nvidia-smi`` line
first and last, ptxas's registers and spills of the dy/dt kernel and of
the cut, and the kernel's bound (``profiling.roofline``).

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked with
``git archive``) it also compiles ``sparse_stage_a.cu`` and
``dense_fused.cu`` of both trees, twice each, to cubins and compares each
kernel's SASS (``cuobjdump -sass``) with the parent's
(:func:`sass_compare`): K1, K3 and K4 must compile to the same code.  It is not part of ``chip_smoke.py``,
which builds the cut alone (:func:`start_build`, :func:`finish_build`).

Run from the repository root: ``python3 probes/dydt_kernel.py [--parent
DIR]``.
"""

import argparse
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
from pyjac_tpu_torch.ops.dydt import dydt  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import flagship  # noqa: E402

# the dy/dt kernel's other plans timed beside the planner's: (states a
# tile, placement)
TILES = ((40, 'shared'), (32, 'shared'), (24, 'shared'), (8, 'shared'),
         (4, 'global'))
LIB = os.path.join(ROOT, 'build', 'probes', 'libdydt_kernel.so')


def start_build():
    """Start nvcc on ``probes/dydt_kernel.cu`` in the background: its
    Popen (read with :func:`finish_build`)."""
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, '-shared', '-o', LIB,
         os.path.join(HERE, 'dydt_kernel.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_report(log):
    """{kernel function: (registers, spill stores + loads in bytes)} from
    nvcc's ``-Xptxas -v`` output."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
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
    return report


def finish_build(proc):
    """The cut's library once ``proc`` has built it, and its
    :func:`ptxas_report`."""
    out = proc.communicate(timeout=900)[0]
    cs.check(proc.returncode == 0, 'nvcc failed:\n%s' % out[-4000:])
    dll = ctypes.CDLL(LIB)
    dll.dyk_k4_cut4.argtypes = kernels.load().pyjac_dense_fused.argtypes
    dll.dyk_k4_cut4.restype = ctypes.c_int
    return dll, {n: r for n, r in ptxas_report(out).items()
                 if 'dense_fused_kernelId' in n}


def cut4_call(dll, mod, y_t, P_t):
    """K4 cut after phase 4 on the launcher's arguments: its f."""
    _, args, (_Jt, f), keep = kernels.tile_args(
        'dense_fused', *kernels.dense_inputs(mod, torch.float64), y_t, P_t)
    err = dll.dyk_k4_cut4(*args)
    cs.check(err == 0, 'K4 cut at 4: CUDA error %d' % err)
    del keep
    return f


def sass(cubin):
    """{kernel function: its SASS instructions} of a cubin."""
    out = subprocess.run([cs.cuobjdump(), '-sass', cubin],
                         capture_output=True, text=True)
    cs.check(out.returncode == 0, 'cuobjdump failed: %s' % out.stderr[-2000:])
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.search(r'/\*[0-9a-f]{4,}\*/', line):
            funcs[name].append(line.strip())
    return funcs


def sass_compare(parent):
    """Compile K1's and K4 / K3's sources of this tree and of ``parent``,
    each twice, to cubins and compare every kernel's SASS with the
    parent's.  nvcc does not always repeat itself: a few of K4 / K3's
    global-placement kernels come out of two builds of one source with
    their instructions scheduled apart.  A kernel that both trees build
    alike twice must equal the parent's instruction for instruction; of
    the others, each build's differing lines are counted against the
    parent's first build, beside the parent's second build's.  Prints,
    per source, the counts, and each side's registers and spills."""
    out = os.path.join(ROOT, 'build', 'probes', 'sass')
    os.makedirs(out, exist_ok=True)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ('-Xcompiler', '-fPIC')]
    jobs, regs = {}, {}
    srcs = ('sparse_stage_a.cu', 'dense_fused.cu')
    for src in srcs:
        for side, root in (('change', ROOT), ('change2', ROOT),
                           ('parent', parent), ('parent2', parent)):
            cubin = os.path.join(out, '%s_%s.cubin' % (side, src[:-3]))
            jobs[src, side] = (cubin, subprocess.Popen(
                [kernels._nvcc(), *flags, '-cubin', '-o', cubin,
                 os.path.join(root, 'pyjac_tpu_torch', 'csrc', src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (src, side), (cubin, proc) in jobs.items():
        log = proc.communicate(timeout=1200)[0]
        cs.check(proc.returncode == 0, 'nvcc %s %s:\n%s' % (side, src,
                                                            log[-4000:]))
        regs[side] = {**regs.get(side, {}), **ptxas_report(log)}
    ok_all = True
    for src in srcs:
        got = {side: sass(jobs[src, side][0])
               for side in ('change', 'change2', 'parent', 'parent2')}
        names = sorted(got['parent'])
        cs.check(all(sorted(g) == names for g in got.values()),
                 '%s: the kernels differ' % src)
        exact, bad, moody = 0, [], []

        def lines_apart(x, y):
            return sum(a != b for a, b in zip(x, y)) + abs(len(x) - len(y))

        for n in names:
            pb = [got['parent'][n], got['parent2'][n]]
            if any(got[c][n] in pb for c in ('change', 'change2')):
                exact += 1
            elif pb[0] != pb[1] or got['change'][n] != got['change2'][n]:
                moody.append('%s: %d instructions, lines apart from the '
                             'parent\'s first build: its second %d, the '
                             'change\'s %d and %d' % (
                                 n[:48], len(pb[0]),
                                 lines_apart(pb[1], pb[0]),
                                 lines_apart(got['change'][n], pb[0]),
                                 lines_apart(got['change2'][n], pb[0])))
            else:
                bad.append(n)
        ok_all &= not bad
        print('SASS %s: %d kernels, %d instructions; the same as a parent '
              'build instruction for instruction: %d; built apart twice by '
              'nvcc itself: %d; different though built alike: %d %s' % (
                  src, len(names), sum(map(len, got['change'].values())),
                  exact, len(moody), len(bad), bad))
        for m in moody:
            print('  ' + m)
    for n in sorted(regs['change']):
        print('  ptxas %s: change %s, parent %s (registers, spilled bytes)'
              % (n[:60], regs['change'][n], regs['parent'].get(n)))
    cs.check(ok_all, 'K1 / K3 / K4 SASS differs from the parent\'s')


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--parent', default=None,
                    help='a checkout whose K1 / K3 / K4 SASS to compare')
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), 'no CUDA device available')
    card = cs.smi_line()
    print(card)
    dev = torch.device('cuda', 0)
    proc = start_build()
    kernels.load()
    for n, r in sorted(ptxas_report(kernels.build_info['log']).items()):
        if 'dydt_kernel' in n:
            print('  ptxas %s: %s (registers, spilled bytes)' % (n[:60], r))
    dll, ptx = finish_build(proc)
    for n, r in sorted(ptx.items()):
        print('  ptxas (K4 cut at 4) %s: %s' % (n[:60], r))

    _, packed = flagship()
    B = 32768
    y, P = cs.flagship_states(B)
    y = torch.as_tensor(y, device=dev)
    P = torch.as_tensor(P, device=dev)
    y_t, P_t = y.T.contiguous(), P[None].contiguous()
    dj = DenseJacobian(packed, device=dev)
    fk = dj.call_tr(y_t, P_t)[1]
    cs.check(torch.equal(cut4_call(dll, dj, y_t, P_t), fk),
             'K4 cut at 4: f differs from K4\'s')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print('planner: %s' % (kernels.tile_plan(dj, torch.float64, B, n_sm,
                                             kernel='dydt'),))
    plans = [None] + [kernels.tile_plan(dj, torch.float64, B, n_sm, tile=t,
                                        placement=pl, kernel='dydt')
                      for t, pl in TILES]
    for plan in plans:
        for yy in (y.T, y_t):
            f = kernels.dydt(dj, yy, P_t, plan=plan)
            cs.check(torch.equal(f, fk), 'dy/dt kernel %s %s: f differs '
                     'from K4\'s' % (plan, yy.stride()))
    bound = cs.bound_of(dj, B, 'dydt')
    print('dy/dt kernel bound at B=%d: %.4f ms (%s; %.4e operations)' % (
        B, *bound))
    rows = {}
    for turn in (0, 1):
        for plan in plans:
            tag = 'planner' if plan is None else '%d %s' % (
                plan['tile'], plan['placement'])
            rows.setdefault('dydt (B, N) ' + tag, []).append(cs.per_call_ms(
                lambda: kernels.dydt(dj, y.T, P_t, plan=plan)))
            rows.setdefault('dydt (N, B) ' + tag, []).append(cs.per_call_ms(
                lambda: kernels.dydt(dj, y_t, P_t, plan=plan)))
        rows.setdefault('K4', []).append(cs.per_call_ms(
            lambda: dj.call_tr(y_t, P_t)))
        rows.setdefault('K4 cut at 4', []).append(cs.per_call_ms(
            lambda: cut4_call(dll, dj, y_t, P_t)))
        rows.setdefault('plain dydt', []).append(cs.best_ms(
            lambda: dydt(packed, 0.0, P, y)))
    print('ms per call, B=%d, flagship PaSR states, two turns (%s):' % (
        B, card))
    for k, v in rows.items():
        print('  %-26s %s' % (k, ' / '.join('%.4f' % t for t in v)))
    print(cs.smi_line())
    if args.parent:
        sass_compare(args.parent)
    return 0


if __name__ == '__main__':
    sys.exit(main())
