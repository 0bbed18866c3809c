"""Probe of the stage-A kernel K1 on one CUDA card.

What it builds, from this checkout's sources into ``build/probes/``:
``probes/stage_a_variants.cu``, K1's own body (``stage_a_block``) at W
warps per 32 states in a kernel that asks the register allocator for a
minimum of blocks per SM (its ``VARIANTS`` table; the launcher's K1 runs
4 warps and names no minimum).

What it measures: each variant at the full width of the 53-species /
325-reaction flagship (its PaSR states tiled to B = 131072) and of the
53/326 all-features synth (``random_states(seed=3)``, B = 131072).  Each
variant is first checked bit-equal to the launcher's
output (src, col0, f, post), then timed as ms per call (10 queued, best
of 3) in two turns beside the launcher's K1.  It prints the card's
``nvidia-smi`` line first and last and the registers ptxas gave each
variant.  It is not part of ``chip_smoke.py``.

Run from the repository root: ``python3 probes/stage_a_kernels.py``.
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
from pyjac_tpu_torch.ops.jacobian_big import PARTS_INT_TABLES  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_sparse import (  # noqa: E402
    FINISH_INT_TABLES, SparseJacobian)
from pyjac_tpu_torch.ops.rates import _LN_PA_RU  # noqa: E402
from pyjac_tpu_torch.testers.synthetic import (  # noqa: E402
    flagship, packed_from_text, synthetic_mechanism)

B = 131072


def build():
    """The variants' library and ptxas's register report per variant."""
    out = os.path.join(ROOT, 'build', 'probes')
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, 'libk1_variants.so')
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-shared',
                          '-o', lib,
                          os.path.join(HERE, 'stage_a_variants.cu')],
                         capture_output=True, text=True)
    cs.check(res.returncode == 0, 'nvcc failed:\n%s' % res.stdout[-4000:] +
             res.stderr[-4000:])
    regs, name = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line) or \
            re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r'Used (\d+) registers', line)
        if m and name:
            regs[name] = int(m.group(1))
    dll = ctypes.CDLL(lib)
    vp, ci, cd, cll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong)
    dll.k1v_count.restype = ci
    dll.k1v_config.argtypes = [ci, vp]
    dll.k1v_launch.argtypes = [ci, vp, vp, cd, vp, vp, cll, vp, vp, vp, vp,
                               vp, vp]
    dll.k1v_launch.restype = ci
    return dll, regs


def configs(dll):
    out = []
    for v in range(dll.k1v_count()):
        c = (ctypes.c_int * 2)()
        dll.k1v_config(v, c)
        out.append(tuple(c))
    return out


def variant_call(dll, v, sj, y_t, P_t):
    """Variant v on the launcher's arguments: its (src, col0, f, post)."""
    dev, N = y_t.device, sj.N
    _, ptrs = kernels._table_ptrs(sj, ('kp_', 'kf_', 'ka_'),
                                  PARTS_INT_TABLES + FINISH_INT_TABLES,
                                  torch.float64, dev)
    dims = kernels._kinetics_dims(sj) + [sj.S_eff]
    cdims = (ctypes.c_int * len(dims))(*dims)
    lib = kernels.load()
    outs = [torch.empty((rows, B), dtype=torch.float64, device=dev)
            for rows in (sj.n_src, N, N, sj.n_post)]
    scratch = torch.empty((lib.pyjac_stage_a_scratch_rows(cdims), B),
                          dtype=torch.float64, device=dev)
    err = dll.k1v_launch(v, ptrs, cdims, _LN_PA_RU, y_t.data_ptr(),
                         P_t.data_ptr(), B, *[o.data_ptr() for o in outs],
                         scratch.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, 'variant %d: CUDA error %d' % (v, err))
    return outs


def main():
    cs.check(torch.cuda.is_available(), 'no CUDA device available')
    card = cs.smi_line()
    print(card)
    dev = torch.device('cuda', 0)
    kernels.load()
    dll, regs = build()
    cfg = configs(dll)
    for name, r in sorted(regs.items()):
        print('  ptxas: %s %d registers' % (name, r))
    cases = [('flagship', flagship()[1]),
             ('synth53', packed_from_text(synthetic_mechanism(
                 53, 325, seed=7))[1])]
    for name, packed in cases:
        y_t, P_t = cs.case_states(name, packed, B, dev)
        sj = SparseJacobian(packed, device=dev)
        ref = kernels.stage_a(sj, y_t, P_t)
        ref = [ref[k] for k in ('src', 'col0', 'f', 'post')]
        run = range(len(cfg))
        for v in run:
            got = variant_call(dll, v, sj, y_t, P_t)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            cs.check(same, '%s: variant %d %s differs from the launcher'
                     % (name, v, cfg[v]))
            del got
        del ref
        torch.cuda.empty_cache()
        times = {}
        for turn in (0, 1):
            times.setdefault('launcher', []).append(cs.per_call_ms(
                lambda: kernels.stage_a(sj, y_t, P_t)))
            for v in run:
                times.setdefault(v, []).append(cs.per_call_ms(
                    lambda: variant_call(dll, v, sj, y_t, P_t)))
        print('%s, B=%d, ms per call (two turns; %s):' % (name, B, card))
        print('  launcher K1            %s' % ' / '.join(
            '%.3f' % t for t in times['launcher']))
        for v in run:
            print('  variant %d W=%d MINB=%d  %s' % (
                v, *cfg[v], ' / '.join('%.3f' % t for t in times[v])))
        del sj, y_t, P_t
        torch.cuda.empty_cache()
    print(cs.smi_line())
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except cs.Fail as e:
        print('stage_a_kernels FAILED: %s' % e, file=sys.stderr)
        sys.exit(1)
