"""Chunked evaluation of large state batches on one card.

PyTorch port of ``pyjac_tpu.parallel.mesh.BatchEvaluator``
(``mesh.py:51-325``), the analog of the reference's GPU capacity loop
(reference: pyjac/pywrap/pyjacob.cu:99-107, tester.cu.in:110-138).  One
device and no mesh: sharding the state batch over several cards is
ROADMAP item 13.  The names are the JAX package's, so each method's
counterpart is found by name.

The parity-precision kernel is chosen as the JAX package chooses it
(``mesh.py:153-162``): ``SparseJacobian`` (K1 + K2), and
``DenseJacobian`` (K4) only where building that raises
``NotImplementedError``.  Both compute in native float64, so there are
no hi/lo pairs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.common import as_f64, entry_device
from ..ops.dydt import dydt as dydt_dispatch
from ..ops.jacobian import jacobian_and_dydt
from ..ops.jacobian_dense import DenseJacobian
from ..ops.jacobian_sparse import SparseJacobian


class BatchEvaluator:
    """Chunked evaluation of dy/dt / Jacobian over huge state batches.

    States are split into chunks that fit the card's memory; each chunk
    is evaluated on ``device`` (the CUDA card unless the caller asks for
    another) and, except in the checksum modes, returned to host memory.
    """

    def __init__(self, packed, conp: bool = True,
                 chunk_size: int | None = None, device='cuda'):
        self.device = entry_device(device)
        self.packed = packed
        self.conp = bool(conp)
        self.chunk_size = int(chunk_size or self._default_chunk())
        self._module = None

    def _default_chunk(self) -> int:
        """Size chunks so the dominant (chunk, R, N) f64 work tensors of
        the plain path use at most ~2 GB."""
        per_state = self.packed.n_reactions * self.packed.n_species * 8
        return min(max(1, int(2e9 / max(per_state, 1))), 32768)

    def _chunks(self, n: int):
        for start in range(0, n, self.chunk_size):
            yield start, min(n, start + self.chunk_size)

    def _inputs(self, y, param):
        y = np.asarray(y, np.float64)
        return y, np.array(np.broadcast_to(np.asarray(param, np.float64),
                                           y.shape[:1]))

    def dydt(self, y, param) -> np.ndarray:
        """dy/dt over an arbitrarily large host batch (the plain f64
        ``dydt``, chunk by chunk)."""
        y, param = self._inputs(y, param)
        out = np.empty_like(y)
        for s, e in self._chunks(y.shape[0]):
            res = dydt_dispatch(self.packed, 0.0, as_f64(param[s:e],
                                                         self.device),
                                as_f64(y[s:e], self.device), conp=self.conp)
            out[s:e] = res.cpu().numpy()
        return out

    def jacobian(self, y, param):
        """(J, dy/dt) over an arbitrarily large host batch (the plain f64
        ``jacobian_and_dydt``, chunk by chunk: the JAX package's XLA
        path)."""
        y, param = self._inputs(y, param)
        N = y.shape[-1]
        J_out = np.empty(y.shape[:1] + (N, N))
        f_out = np.empty_like(y)
        for s, e in self._chunks(y.shape[0]):
            J, f = jacobian_and_dydt(self.packed, 0.0,
                                     as_f64(param[s:e], self.device),
                                     as_f64(y[s:e], self.device),
                                     conp=self.conp)
            J_out[s:e] = J.cpu().numpy()
            f_out[s:e] = f.cpu().numpy()
        return J_out, f_out

    def _dd_kernel(self):
        """The parity-precision module for this mechanism, built once:
        ``SparseJacobian``, or ``DenseJacobian`` where that raises
        ``NotImplementedError``."""
        if self._module is None:
            try:
                self._module = SparseJacobian(self.packed, conp=self.conp,
                                              device=self.device)
            except NotImplementedError:
                self._module = DenseJacobian(self.packed, conp=self.conp,
                                             device=self.device)
        return self._module

    def _checksum(self, y_t, P_t):
        """The sum of every output element of one batch-minor call, on
        the device (a NaN anywhere poisons it)."""
        return sum(torch.sum(x) for x in self._dd_kernel().call_tr(y_t, P_t))

    def jacobian_dd(self, y, param, return_results: bool = True):
        """(J, dy/dt) at parity precision over an arbitrarily large host
        batch, each chunk through the module of :meth:`_dd_kernel`.

        ``return_results=False`` streams the batch through the card with
        one device-side checksum per chunk instead of returning the
        Jacobians to the host, and returns the sum of the checksums (one
        host sync at the end)."""
        mod = self._dd_kernel()
        y, param = self._inputs(y, param)
        n, N = y.shape
        if return_results:
            J_out = np.empty((n, N, N))
            f_out = np.empty((n, N))
            for s, e in self._chunks(n):
                J, f = mod(y[s:e], param[s:e])
                J_out[s:e] = J.cpu().numpy()
                f_out[s:e] = f.cpu().numpy()
            return J_out, f_out
        acc = torch.zeros((), dtype=torch.float64, device=self.device)
        for s, e in self._chunks(n):
            y_t = as_f64(y[s:e].T.copy(), self.device)
            P_t = as_f64(param[None, s:e].copy(), self.device)
            acc = acc + self._checksum(y_t, P_t)
        return float(acc)

    def jacobian_dd_resident(self, y, param, chunk_b: int = 0,
                             passes: int = 2):
        """Device-resident chunked evaluation: the 1M-state benchmark
        loop.

        Stages the whole ensemble to the device once (453 MB of f64 at
        1M flagship states), chunk-major: chunk i holds its states
        [s_i, e_i) as an (N, e_i - s_i) batch-minor block, the blocks
        back to back, so every chunk, the ragged last one included, is a
        contiguous view the kernels take as it is.  Then each pass loops
        the chunks on the device and reduces every output element into
        one checksum, with one host sync per pass; the best of
        ``passes`` is the compute time.

        Returns ``(checksum, stats)`` with the JAX package's stats keys
        (``states``: the states evaluated, each once; ``compile_s``: the
        untimed first pass, which builds the kernels on first use) and
        ``kernel``, the module that ran."""
        mod = self._dd_kernel()
        y, param = self._inputs(y, param)
        n, N = y.shape
        chunk_b = int(chunk_b) if chunk_b > 0 else min(131072, n)
        spans = [(s, min(n, s + chunk_b)) for s in range(0, n, chunk_b)]
        host_y = np.concatenate([y[s:e].T.ravel() for s, e in spans])
        host_P = np.ascontiguousarray(param)
        n_bytes = host_y.nbytes + host_P.nbytes

        t0 = time.perf_counter()
        dev_y = torch.from_numpy(host_y).to(self.device)
        dev_P = torch.from_numpy(host_P).to(self.device)
        float(dev_y[-1] + dev_P[-1])        # the copies have landed
        staging_s = time.perf_counter() - t0
        views = [(dev_y[N * s:N * e].view(N, e - s), dev_P[s:e].view(1, e - s))
                 for s, e in spans]

        def one_pass():
            acc = torch.zeros((), dtype=torch.float64, device=self.device)
            for y_t, P_t in views:
                acc = acc + self._checksum(y_t, P_t)
            return float(acc)                # the pass's one host sync

        t0 = time.perf_counter()
        one_pass()
        compile_s = time.perf_counter() - t0
        chk, pass_s = None, []
        for _ in range(max(1, passes)):
            t0 = time.perf_counter()
            chk = one_pass()
            pass_s.append(time.perf_counter() - t0)
        compute_s = min(pass_s)
        stats = {
            'states': n, 'chunk_b': chunk_b, 'n_chunks': len(spans),
            'staging_s': staging_s, 'staging_bytes': n_bytes,
            'staging_mb_s': n_bytes / 1e6 / max(staging_s, 1e-9),
            'compile_s': compile_s, 'compute_s': compute_s,
            'pass_s': pass_s, 'evals_per_s': n / max(compute_s, 1e-9),
            'kernel': type(mod).__name__,
        }
        return chk, stats
