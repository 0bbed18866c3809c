"""Probe of the column kernels K6/K2x and K7 on one CUDA card.

What it builds, from this checkout's sources into ``build/probes/``:

* ``probes/k6_variants.cu``: the one-thread-per-(state, column) kernel
  K6 and K2x ran before their redesign, (a) the same with the post rows
  held in registers, (b) the same without the CSR contraction;
* ``probes/column_configs.cu``: the redesigned kernels at several block
  configurations (``g<G>t<TN>s<STAGES>p<SPL>``);
* the same configurations from copies of ``pyjac_tpu_torch/csrc`` with
  one change each: ``cs``, the output stored cache-streaming
  (``__stcs``); ``u4``, the CSR entry loop unrolled by 4.

What it measures: K6 at the 654-species class, B = 1024, K7 there at
B = 1024 and 512, and K2x on the flagship's unfused path at B = 131072.
Each configuration is first checked bit-equal to the launcher's output
(the launcher's own against its plain version, on the phase-6 gates of
``chip_smoke.py``), then timed as ms per call (10 queued, best of 3) in
two turns beside the old kernel, its variants, ``torch.bmm`` and
``zero_`` of the output.  It prints the card's ``nvidia-smi`` line
first and last.  It is not part of ``chip_smoke.py``.

Run from the repository root: ``python3 probes/column_kernels.py``.
"""

import ctypes
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pyjac_tpu_torch.ops import kernels  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_big import (  # noqa: E402
    BigJacobian, cols_dense_reference, cols_sparse_reference, finish,
    source_stack, state_thermo)
from pyjac_tpu_torch.ops.jacobian_sparse import (  # noqa: E402
    SparseJacobian, stage_b_reference)
from pyjac_tpu_torch.testers.synthetic import (  # noqa: E402
    flagship, packed_from_text, plausible_mechanism)

KS = ['g8t8s2p4', 'g8t16s2p1', 'g8t8s2p2', 'g8t8s3p2', 'g16t8s2p2',
      'g4t8s2p4', 'g8t16s2p4']
KD = ['g16t16s2p1', 'g8t16s2p1', 'g8t8s2p1', 'g4t8s2p2']
# one-change copies of csrc/columns.cuh, timed at these configurations
PATCHED = ['g8t8s2p4', 'g16t8s2p2', 'g16t16s2p1']
LOOP = '      for (int e = pw[i]; e < pw[i + 1]; ++e) {'
STORE = ('col[(size_t)(1 + n) * B + WARP * k + lane] =\n'
         '              p[(4 * TN + i) * T::TB] * dcol - '
         'p[(3 * TN + i) * T::TB] * r_j[k];')
PATCHES = {
    'cs': (STORE, '__stcs(&col[(size_t)(1 + n) * B + WARP * k + lane],\n'
                  '              p[(4 * TN + i) * T::TB] * dcol - '
                  'p[(3 * TN + i) * T::TB] * r_j[k]);'),
    'u4': (LOOP, '#pragma unroll 4\n' + LOOP),
}
VP, CI, CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
P = kernels._ptr


def build(out_dir, name, src, inc):
    so = os.path.join(out_dir, name)
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, '-shared', '-I',
                        inc, '-o', so, src], capture_output=True, text=True)
    if r.returncode:
        sys.exit('nvcc failed for %s:\n%s%s' % (name, r.stdout, r.stderr))
    for line in (r.stdout + r.stderr).splitlines():
        if 'registers' in line or 'Compiling entry' in line:
            print('  ' + line.strip()[:150])
    lib = ctypes.CDLL(so)
    return lib


def bind(lib, kinds):
    for c in kinds.get('s', ()):
        getattr(lib, 'ks_' + c).argtypes = [VP] * 7 + [CI, CI, CI, CLL, VP]
    for c in kinds.get('d', ()):
        getattr(lib, 'kd_' + c).argtypes = [VP] * 12 + [CI] * 6 + [CLL, VP]
    for k, cfgs in kinds.items():
        for c in cfgs:
            getattr(lib, 'occ%s_%s' % (k, c)).argtypes = [CI]
            getattr(lib, 'smem%s_%s' % (k, c)).argtypes = [CI]
            getattr(lib, 'smem%s_%s' % (k, c)).restype = CLL


def gates(tag, got, plain, mod, dcol, post, conp=True):
    e = cs.floored_err(got, plain, 1e-10)
    gross = cs.t_row_gross(dcol, mod.inv_mw, post, conp)
    jt = float(((got[:, 0] - plain[:, 0]).abs() / gross).max())
    print('%s launcher vs plain: J species rows floored@1e-10 %.3e (<= %.0e), '
          'T row on its terms %.3e (<= %.0e)' % (
              tag, float(e[:, 1:].max()), cs.TOL_BIG_J, jt, cs.TOL_BIG_JT))


def sweep(tag, libs, kind, rows, call, ref, extra):
    """Check each (library, configuration) bit-equal to ``ref``, then
    time all of them and ``extra`` in two turns."""
    out = torch.empty_like(ref)
    fns = {}
    for tl, (lib, cfgs) in libs.items():
        for c in cfgs:
            f = call(lib, kind, c, out)
            err = f()
            torch.cuda.synchronize()
            if err:
                print('%s %s%s: error %d' % (tag, c, tl, err))
                continue
            print('%s %s%s: bit-equal to the launcher %s, %d blocks/SM, '
                  'shared memory %d B' % (
                      tag, c, tl, bool(torch.equal(out, ref)),
                      getattr(lib, 'occ%s_%s' % (kind, c))(rows),
                      getattr(lib, 'smem%s_%s' % (kind, c))(rows)))
            fns[c + tl] = f
    res = {}
    for _ in range(2):
        for nm, f in list(extra.items()) + list(fns.items()):
            res.setdefault(nm, []).append(cs.per_call_ms(f))
    for nm, v in res.items():
        print('%s %-14s %s ms' % (tag, nm, ' '.join('%.4f' % x for x in v)))


def main():
    if not torch.cuda.is_available():
        sys.exit('no CUDA device available')
    dev = torch.device('cuda', 0)
    stream = lambda: kernels._stream(dev)
    print(cs.smi_line(), flush=True)
    kernels.load()
    out_dir = os.path.join(ROOT, 'build', 'probes')
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(kernels.CSRC)
    old = build(out_dir, 'libk6_variants.so',
                os.path.join(HERE, 'k6_variants.cu'), csrc)
    for nm in ('orig', 'a', 'b'):
        getattr(old, 'v_' + nm).argtypes = [VP] * 7 + [CI, CI, CLL, VP]
    libs_s = {'': (build(out_dir, 'libcolumn_configs.so',
                         os.path.join(HERE, 'column_configs.cu'), csrc), KS)}
    libs_d = {'': (libs_s[''][0], KD)}
    bind(libs_s[''][0], {'s': KS, 'd': KD})
    for tl, (a, b) in PATCHES.items():
        d = os.path.join(out_dir, 'csrc_' + tl)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        path = os.path.join(d, 'columns.cuh')
        body = open(path).read()
        if a not in body:
            sys.exit('patch %s does not apply to csrc/columns.cuh' % tl)
        open(path, 'w').write(body.replace(a, b))
        lib = build(out_dir, 'libcolumn_configs_%s.so' % tl,
                    os.path.join(HERE, 'column_configs.cu'), d)
        bind(lib, {'s': KS, 'd': KD})
        libs_s[tl] = (lib, [c for c in KS if c in PATCHED])
        libs_d[tl] = (lib, [c for c in KD if c in PATCHED])

    def call(lib, kind, c, out, mod, op, post, prefix, B):
        if kind == 's':
            ptr, src, coef = (getattr(mod, prefix + k)
                              for k in ('ptr', 'src', 'coef'))
            return lambda: getattr(lib, 'ks_' + c)(
                P(ptr), P(src), P(coef), P(mod.inv_mw), P(op), P(post),
                P(out), mod.N, mod.Rmax, 1, B, stream())
        t = mod.tab('kd_')
        return lambda: getattr(lib, 'kd_' + c)(
            *(P(t[k]) for k in ('act', 'ptr', 'src', 'coef', 'spf', 'spp',
                                'eff', 'pd')), P(mod.inv_mw), P(op), P(post),
            P(out), mod.N, mod.R, mod.Sf, mod.Sp, t['act'].shape[1], 1, B,
            stream())

    def old_runs(mod, op, post, prefix, B, out):
        ptr, src, coef = (getattr(mod, prefix + k)
                          for k in ('ptr', 'src', 'coef'))
        return {'old ' + nm: (lambda nm=nm: getattr(old, 'v_' + nm)(
            P(ptr), P(src), P(coef), P(mod.inv_mw), P(op), P(post), P(out),
            mod.N, 1, B, stream())) for nm in ('orig', 'a', 'b')}

    # --- K6 at the 654 class, B = 1024; K7 there at B = 1024 and 512 ----
    p654 = packed_from_text(plausible_mechanism(654, 2716, seed=5))[1]
    bj = BigJacobian(p654, device=dev)
    bd = BigJacobian(p654, device=dev, sparse_cols=False)
    print('K7 tables: A = %d active-reaction slots per column, %d CSR '
          'entries' % (bd.kd_act.shape[1], bd.kd_src.numel()))
    for B in (1024, 512):
        y_t, P_t = cs.big_states(p654, B, dev)
        st = state_thermo(bj.packed, y_t, P_t, True)
        roles = bj.parts(st)
        post = finish(bj.packed, st, roles, True)['post']
        if B == 1024:
            p1c = bj.assemble_p1c(source_stack(roles, bj.Sf + bj.Sp,
                                               bj.eff_val))
            ref = kernels.big_cols_sparse(bj, p1c, post)
            gates('K6 654 B=1024', ref, cols_sparse_reference(
                p1c, bj.ks_nuc, bj.inv_mw, post, True), bj,
                cs.big_dcol(bj, roles), post)
            scratch = torch.empty_like(ref)
            extra = old_runs(bj, p1c, post, 'ks_', B, scratch)
            extra['torch.bmm'] = lambda: torch.bmm(
                bj.ks_nuc, p1c.view(bj.J, bj.Rmax, B))
            extra['zero_'] = lambda: scratch.zero_()
            sweep('K6 654 B=1024', libs_s, 's', bj.Rmax,
                  lambda lib, k, c, out: call(lib, k, c, out, bj, p1c, post,
                                              'ks_', B), ref, extra)
            del p1c, scratch
        ref = kernels.big_cols_dense(bd, roles, post)
        gates('K7 654 B=%d' % B, ref, cols_dense_reference(
            roles, bd.tab('kd_'), bd.inv_mw, post, True), bd,
            cs.big_dcol(bd, roles), post)
        sweep('K7 654 B=%d' % B, libs_d, 'd', bd.kd_act.shape[1],
              lambda lib, k, c, out: call(lib, k, c, out, bd, roles, post,
                                          'kd_', B), ref, {})
        del ref, roles, post, st
        torch.cuda.empty_cache()

    # --- K2x on the flagship's unfused path, B = 131072 -------------------
    _, pf = flagship()
    B = 131072
    sx = SparseJacobian(pf, fuse_gather=False, device=dev)
    yx, Px = cs.to_tr(*cs.flagship_states(B), dev)
    a = sx.stage_a(yx, Px)
    p1 = sx.stage_gather(a['src'])
    ref = kernels.stage_b_x(sx, p1, a['post'])
    rows = torch.arange(sx.J * sx.Rmax, device=dev).view(sx.J, sx.Rmax)
    print('K2x flagship B=%d launcher vs plain: J floored@1e-10 %.3e '
          '(<= %.0e)' % (B, cs.floored(ref, stage_b_reference(
              rows, sx.nuc, sx.inv_mw, p1, a['post']), 1e-10), cs.TOL_J))
    scratch = torch.empty_like(ref)
    extra = old_runs(sx, p1, a['post'], 'kx_', B, scratch)
    extra['torch.bmm'] = lambda: torch.bmm(sx.nuc, p1.view(sx.J, sx.Rmax, B))
    extra['zero_'] = lambda: scratch.zero_()
    sweep('K2x flagship B=%d' % B, libs_s, 's', sx.Rmax,
          lambda lib, k, c, out: call(lib, k, c, out, sx, p1, a['post'],
                                      'kx_', B), ref, extra)
    print(cs.smi_line())


if __name__ == '__main__':
    main()
