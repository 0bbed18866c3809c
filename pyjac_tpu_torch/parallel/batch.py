"""Chunked evaluation of large state batches on one card.

PyTorch port of ``pyjac_tpu.parallel.mesh.BatchEvaluator``
(``mesh.py:51-325``), the analog of the reference's GPU capacity loop
(reference: pyjac/pywrap/pyjacob.cu:99-107, tester.cu.in:110-138).  With
a mesh of several devices (:mod:`.mesh`), each chunk is split over
them.  The names are the JAX package's, so each method's counterpart is
found by name.

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

# the share of a card's memory that one default chunk of
# jacobian_dd_resident may take for its outputs, J and dy/dt: a pass holds
# one chunk's outputs and K1's intermediates (up to 0.83 times the outputs,
# at the flagship) at once beside the staged ensemble, so a quarter keeps a
# chunk's whole footprint within half the card
RESIDENT_OUTPUT_SHARE = 0.25


def resident_chunk(N: int, n: int, memory=None) -> int:
    """:meth:`BatchEvaluator.jacobian_dd_resident`'s default chunk of
    ``n`` states of width ``N``: at most 131072, and on a card of
    ``memory`` bytes no more states than keep the chunk's J and dy/dt,
    (N^2 + N) 8 bytes a state, within :data:`RESIDENT_OUTPUT_SHARE` of
    it (``memory`` None, the host, caps nothing more)."""
    fit = n if memory is None else \
        int(RESIDENT_OUTPUT_SHARE * memory) // ((N * N + N) * 8)
    return max(1, min(131072, n, fit))


class BatchEvaluator:
    """Chunked evaluation of dy/dt / Jacobian over huge state batches.

    States are split into chunks that fit a device's memory; each chunk
    is evaluated on ``device`` (the CUDA card unless the caller asks for
    another) or, given a ``mesh`` of this process's devices
    (:func:`.mesh.make_mesh`), split over its shards, each on its device;
    and, except in the checksum modes, returned to host memory.
    ``mesh=None`` (one device) is the JAX package's one-device mesh; the
    device-resident loop takes that alone.
    """

    def __init__(self, packed, mesh=None, conp: bool = True,
                 chunk_size: int | None = None, device='cuda'):
        if mesh is not None and mesh.world > 1:
            raise ValueError('BatchEvaluator returns the whole batch to this '
                             'process: give it a mesh of its own devices '
                             '(sharded_step spans processes)')
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else \
            entry_device(device)
        self.packed = packed
        self.conp = bool(conp)
        self.chunk_size = int(chunk_size or self._default_chunk())
        self._modules = {}

    def _default_chunk(self) -> int:
        """Size chunks so the dominant (chunk, R, N) f64 work tensors of
        the plain path use at most ~2 GB."""
        per_state = self.packed.n_reactions * self.packed.n_species * 8
        return min(max(1, int(2e9 / max(per_state, 1))), 32768)

    def _chunks(self, n: int):
        for start in range(0, n, self.chunk_size):
            yield start, min(n, start + self.chunk_size)

    def _shards(self, s: int, e: int) -> list:
        """[(device, start, stop)] of the chunk [s, e): the mesh's
        non-empty shards of it, or the whole chunk on the device."""
        if self.mesh is None:
            return [(self.device, s, e)]
        from .mesh import _local_shards
        return [(dev, s + a, s + b)
                for dev, a, b in _local_shards(self.mesh, e - s)]

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
            # every shard's work queued before the first copy back
            res = [(a, b, dydt_dispatch(self.packed, 0.0,
                                        as_f64(param[a:b], dev),
                                        as_f64(y[a:b], dev), conp=self.conp))
                   for dev, a, b in self._shards(s, e)]
            for a, b, f in res:
                out[a:b] = f.cpu().numpy()
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
            res = [(a, b, jacobian_and_dydt(self.packed, 0.0,
                                            as_f64(param[a:b], dev),
                                            as_f64(y[a:b], dev),
                                            conp=self.conp))
                   for dev, a, b in self._shards(s, e)]
            for a, b, (J, f) in res:
                J_out[a:b] = J.cpu().numpy()
                f_out[a:b] = f.cpu().numpy()
        return J_out, f_out

    def _dd_kernel(self, device=None):
        """The parity-precision module for this mechanism on ``device``
        (default the first), built once: ``SparseJacobian``, or
        ``DenseJacobian`` where that raises ``NotImplementedError``."""
        dev = self.device if device is None else device
        if dev not in self._modules:
            try:
                mod = SparseJacobian(self.packed, conp=self.conp, device=dev)
            except NotImplementedError:
                mod = DenseJacobian(self.packed, conp=self.conp, device=dev)
            self._modules[dev] = mod
        return self._modules[dev]

    def _checksum(self, y_t, P_t):
        """The sum of every output element of one batch-minor call, on
        the device (a NaN anywhere poisons it)."""
        mod = self._dd_kernel(y_t.device)
        return sum(torch.sum(x) for x in mod.call_tr(y_t, P_t))

    def jacobian_dd(self, y, param, return_results: bool = True):
        """(J, dy/dt) at parity precision over an arbitrarily large host
        batch, each chunk through the module of :meth:`_dd_kernel`.

        ``return_results=False`` streams the batch through the card with
        one device-side checksum per chunk instead of returning the
        Jacobians to the host, and returns the sum of the checksums (one
        host sync at the end)."""
        y, param = self._inputs(y, param)
        n, N = y.shape
        if return_results:
            J_out = np.empty((n, N, N))
            f_out = np.empty((n, N))
            for s, e in self._chunks(n):
                res = [(a, b, self._dd_kernel(dev)(y[a:b], param[a:b]))
                       for dev, a, b in self._shards(s, e)]
                for a, b, (J, f) in res:
                    J_out[a:b] = J.cpu().numpy()
                    f_out[a:b] = f.cpu().numpy()
            return J_out, f_out
        acc = {}
        for s, e in self._chunks(n):
            for dev, a, b in self._shards(s, e):
                y_t = as_f64(y[a:b].T.copy(), dev)
                P_t = as_f64(param[None, a:b].copy(), dev)
                acc[dev] = acc.get(dev, 0.0) + self._checksum(y_t, P_t)
        return sum(float(v) for v in acc.values())

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
        ``kernel``, the module that ran.  ``chunk_b`` 0 takes
        :func:`resident_chunk`'s for the device.  It runs on one device:
        a mesh of several raises ``ValueError``."""
        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError('jacobian_dd_resident stages the ensemble on '
                             'one device; got a mesh of %d'
                             % self.mesh.size)
        mod = self._dd_kernel()
        y, param = self._inputs(y, param)
        n, N = y.shape
        memory = torch.cuda.get_device_properties(self.device).total_memory \
            if self.device.type == 'cuda' else None
        chunk_b = int(chunk_b) if chunk_b > 0 else \
            resident_chunk(N, n, memory)
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
