"""Performance test harness.

Port of ``pyjac_tpu/testers/performance.py`` (the rebuild of the
reference's performance tester,
pyjac/performance_tester/performance_tester.py:213-508):

* walks a work directory for mechanism folders containing a mechanism
  file plus PaSR state data (``*.npy``) (reference :241-256),
* packs the state data into a raw-double ``data.bin``
  (reference :316-338) — read back through the native C loader in
  :mod:`pyjac_tpu_torch.runtime` when available,
* sweeps an option matrix — Jacobian method x state count (powers of
  two up to the dataset size, reference :341-347); each method computes
  in one precision (:data:`METHOD_PRECISION`), which names its file,
* appends ``num_odes,runtime_ms`` lines to per-configuration output
  files, with the reference's resume-by-line-count semantics
  (reference :71-142),
* repeats each configuration (default 10, reference :269-270).

The methods and what runs them:

=============  ==========================================  =============
method         port entry                                  on the card
=============  ==========================================  =============
``ajac``       ``jacobian_and_dydt``                       plain torch
``ad``         ``jacobian_fwd``                            plain torch
``fd``         ``fd_jacobian(order=1)``                    plain torch
``pallas``     ``F32Jacobian.call_tr``                     K3
``dd``         ``DenseJacobian.call_tr``                   K4
``dd-sparse``  ``SparseJacobian(fuse_gather=True).call_tr``  K1 + K2
=============  ==========================================  =============

The sweep runs on the CUDA card unless the caller asks for the CPU,
where the same methods run the kernels' plain versions.  The measured
quantity matches the reference drivers: wall-clock for N fused
Jacobian(+dydt) evaluations with a host synchronisation at the end
(reference: tester.c.in:23-31, tester.cu.in:109-156).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.common import cached, entry_device

# the precision each method computes in: 'pallas' is the float32 kernel
# K3; every other method computes in float64 (the plain ops, K4, K1 + K2)
METHOD_PRECISION = {'pallas': 'f32'}


def method_precision(method: str) -> str:
    return METHOD_PRECISION.get(method, 'f64')


def _check_precisions(methods, dtypes) -> None:
    """Refuse a requested precision that some method does not compute
    in: the precision follows the method."""
    bad = ['%s (%s)' % (m, method_precision(m)) for m in methods
           if any(d != method_precision(m) for d in dtypes or ())]
    if bad:
        raise NotImplementedError(
            'precision %s asked for methods %s: each method computes in '
            "one precision, 'pallas' in float32 (f32), every other method "
            'in float64 (f64)' % (list(dtypes), bad))


@dataclass
class PerfConfig:
    mech_name: str
    method: str       # 'ajac' | 'ad' | 'fd' | 'pallas' | 'dd' | 'dd-sparse'
    dtype: str        # 'f64' | 'f32'
    num_states: int
    repeats: int = 10

    @property
    def filename(self) -> str:
        return '{}_{}_{}_output.txt'.format(self.mech_name, self.method,
                                            self.dtype)


def find_mechanisms(work_dir: str):
    """Yield (name, mech_path, thermo_path_or_None, data_path) per
    mechanism subfolder (reference :241-256)."""
    for entry in sorted(os.listdir(work_dir)):
        sub = os.path.join(work_dir, entry)
        if not os.path.isdir(sub):
            continue
        mech = None
        thermo = None
        data = None
        for fn in sorted(os.listdir(sub)):
            low = fn.lower()
            if low.endswith('.cti'):
                mech = os.path.join(sub, fn)
            elif low.endswith(('.inp', '.dat')) and mech is None:
                if 'therm' in low:
                    thermo = os.path.join(sub, fn)
                else:
                    mech = os.path.join(sub, fn)
            elif 'therm' in low and low.endswith(('.dat', '.inp')):
                thermo = os.path.join(sub, fn)
            elif low.endswith('.npy'):
                data = os.path.join(sub, fn)
        if mech and data:
            yield entry, mech, thermo, data


def pack_data_bin(npy_path: str, out_path: str) -> int:
    """PaSR .npy -> raw little-endian doubles 'data.bin', rows of
    (t, T, P, Y...) (reference :316-338), written through the native
    runtime. Returns the row count."""
    from ..runtime import stateio
    data = np.load(npy_path)
    data = data.reshape(-1, data.shape[-1])
    stateio.save_raw(out_path, data)
    return data.shape[0]


def check_step_file(path: str, repeats: int) -> dict:
    """Parse an existing output file into {num_odes: runs_completed}
    (reference's resume logic, :71-109)."""
    done = {}
    if not os.path.exists(path):
        return done
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split(',')
            if len(parts) != 2:
                continue
            try:
                n = int(parts[0])
                float(parts[1])
            except ValueError:
                continue
            done[n] = done.get(n, 0) + 1
    return done


def step_sizes(total: int, minimum: int = 256) -> List[int]:
    """Powers of two up to the dataset size (reference :341-347)."""
    steps = []
    n = minimum
    while n < total:
        steps.append(n)
        n *= 2
    steps.append(total)
    return steps


def _kernel_module(packed, method: str, device):
    """The kernel module of a kernel method, built once per (mechanism,
    method, device) and cached while the mechanism lives."""
    from ..ops.jacobian_dense import DenseJacobian
    from ..ops.jacobian_f32 import F32Jacobian
    from ..ops.jacobian_sparse import SparseJacobian

    def build():
        if method == 'dd-sparse':
            return SparseJacobian(packed, fuse_gather=True, device=device)
        if method == 'dd':
            return DenseJacobian(packed, device=device)
        try:
            return F32Jacobian(packed, device=device)
        except NotImplementedError as e:
            raise NotImplementedError(
                'pallas path does not cover this mechanism: %s' % e) from e

    return cached(packed, ('perf', method, str(device)), build)


def _timed_eval(packed, method: str, y: np.ndarray, P: np.ndarray,
                best_of: int = 3, device='cuda') -> float:
    """Best-of-N timed pass over the batch on ``device``; returns wall
    ms.

    Measurement methodology: the states are staged on the device
    before the timed window (the kernel methods as the (N, B) / (1, B)
    tensors of ``call_tr``); the window holds the call,
    a ``torch.sum`` of its FULL outputs (no part of the work can be
    skipped) and one host synchronisation through the scalar's transfer;
    one untimed pass warms up, then the best of ``best_of`` counts.
    """
    from ..ops.jacobian import jacobian_and_dydt, jacobian_fwd
    from .functional import fd_jacobian

    device = entry_device(device)
    if method in ('dd', 'dd-sparse', 'pallas'):
        mod = _kernel_module(packed, method, device)
        wdt = (torch.float32 if method_precision(method) == 'f32'
               else torch.float64)
        y_t = torch.as_tensor(np.ascontiguousarray(y.T), dtype=wdt,
                              device=device)
        P_t = torch.as_tensor(np.asarray(P)[None], dtype=wdt, device=device)

        def fn():
            return _checksum(mod.call_tr(y_t, P_t))
    else:
        yb = torch.as_tensor(np.asarray(y, np.float64), device=device)
        Pb = torch.as_tensor(np.asarray(P, np.float64), device=device)
        if method == 'ajac':
            def fn():
                return _checksum(jacobian_and_dydt(packed, 0.0, Pb, yb))
        elif method == 'ad':
            def fn():
                return _checksum((jacobian_fwd(packed, 0.0, Pb, yb),))
        elif method == 'fd':
            def fn():
                return _checksum((fd_jacobian(packed, 0.0, Pb, yb,
                                              order=1),))
        else:
            raise ValueError(method)

    chk = float(fn())                # warm-up
    if not np.isfinite(chk):
        raise RuntimeError('non-finite checksum in %s timing' % method)
    best = float('inf')
    for _ in range(best_of):
        t0 = time.perf_counter()
        float(fn())                  # host sync via scalar transfer
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _checksum(arrays):
    """Reduce EVERY output element to one scalar: a strided or sliced
    reduction would time less than the whole output (see
    docs/performance.md); full sums keep every element while the host
    transfer stays one scalar."""
    total = 0.0
    for a in arrays:
        total = total + torch.sum(a)
    return total


def performance_tester(work_dir: str, methods: Sequence[str] = ('ajac',),
                       dtypes: Optional[Sequence[str]] = None,
                       repeats: int = 10,
                       steps: Optional[Sequence[int]] = None,
                       verbose: bool = True, device='cuda') -> None:
    """Run the sweep on ``device`` (the CUDA card unless the caller asks
    for the CPU); resume-able (reference :213-508).  Each method runs in
    its own precision (:func:`method_precision`); ``dtypes``, where
    given, must name only that precision for every method."""
    from ..core.mech import Mechanism
    from ..core.pack import pack
    from ..runtime import stateio

    device = entry_device(device)
    _check_precisions(methods, dtypes)

    out_dir = os.path.join(work_dir, 'output')
    os.makedirs(out_dir, exist_ok=True)

    for name, mech_path, thermo_path, data_path in \
            find_mechanisms(work_dir):
        mech = Mechanism.from_files(mech_path, thermo_path)
        packed = pack(mech)

        bin_path = os.path.join(work_dir, name, 'data.bin')
        pack_data_bin(data_path, bin_path)
        # load + pivot through the native runtime (read_initial_conditions
        # analog)
        raw = stateio.load_raw(bin_path, 3 + packed.n_species)
        y_all, P, _ = stateio.build_states(raw, mech.fwd_spec_mapping)

        sizes = list(steps) if steps else step_sizes(len(y_all))
        for method in methods:
            cfg = PerfConfig(name, method, method_precision(method), 0,
                             repeats)
            out_path = os.path.join(out_dir, cfg.filename)
            done = check_step_file(out_path, repeats)
            with open(out_path, 'a') as fh:
                for n in sizes:
                    todo = repeats - done.get(n, 0)
                    if todo <= 0:
                        if verbose:
                            print('skip (resume): %s n=%d' %
                                  (cfg.filename, n))
                        continue
                    reps = np.tile(y_all, (int(np.ceil(n / len(y_all))), 1))
                    yb = reps[:n]
                    Pb = np.tile(P, int(np.ceil(n / len(P))))[:n]
                    for _ in range(todo):
                        ms = _timed_eval(packed, method, yb, Pb,
                                         device=device)
                        fh.write('{},{}\n'.format(n, ms))
                        fh.flush()
                        if verbose:
                            print('%s: %d odes  %.3f ms  (%.0f evals/s)' %
                                  (cfg.filename, n, ms, n / ms * 1e3))


def main(argv=None) -> int:
    """``python -m pyjac_tpu_torch.testers.performance``
    (reference parity: pyjac/performance_tester/__main__.py:7-28)."""
    import argparse
    parser = argparse.ArgumentParser(
        prog='pyjac_tpu_torch.testers.performance',
        description='Performance sweep over mechanism folders in a work '
                    'directory (resume-able).')
    parser.add_argument('-w', '--working_dir', required=True,
                        help='Directory with per-mechanism subfolders '
                             '(mechanism file + PaSR .npy).')
    parser.add_argument('-m', '--methods', nargs='+',
                        default=['ajac'],
                        choices=['ajac', 'ad', 'fd', 'pallas', 'dd',
                                 'dd-sparse'])
    parser.add_argument('-p', '--precisions', nargs='+',
                        default=None, choices=['f64', 'f32'],
                        help="each method computes in one precision, "
                             "'pallas' in f32 and every other in f64 (the "
                             'default); a precision a method does not '
                             'compute in is refused')
    parser.add_argument('-r', '--repeats', type=int, default=10)
    parser.add_argument('-s', '--steps', type=int, nargs='*', default=None)
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default: the card's kernels) or "
                             "'cpu' (their plain versions)")
    args = parser.parse_args(argv)
    performance_tester(args.working_dir, methods=args.methods,
                       dtypes=args.precisions, repeats=args.repeats,
                       steps=args.steps, device=args.device)
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
