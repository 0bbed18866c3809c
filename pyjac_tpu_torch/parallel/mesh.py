"""Batch parallelism over several devices and processes.

PyTorch port of ``pyjac_tpu/parallel/mesh.py``.  The reference's only
distribution axis is the thermochemical-state batch (OpenMP threads /
one CUDA thread per state, reference:
pyjac/performance_tester/tester.c.in:24-29, pyjac/pywrap/pyjacob.cu:
14-35).  The JAX package makes it a ``jax.sharding.Mesh`` with one
``'batch'`` axis; here a :class:`Mesh` is this process's devices plus,
when one is initialised, the ``torch.distributed`` process group whose
processes each bring theirs (one card each, on CUDA).  The kernels are
embarrassingly parallel (no collective in the hot path); only the error
norm of a step crosses devices, as ``torch.distributed.all_reduce(MAX)``.

A sharded step takes the whole batch on every process and evaluates this
process's shards of it (:func:`batch_sharding`: contiguous blocks of
ceil(B / mesh size) states, in rank and device order), each on its
device; it returns those rows, concatenated on the process's first
device, and the norm over every shard of every process.  On the CPU the
shards of a mesh are virtual devices, all on the one CPU device (the
analog of the JAX package's forced host device count).

:class:`~.batch.BatchEvaluator` (also importable from here) splits each
chunk over a mesh of this process's devices.
"""

from __future__ import annotations

import os
import pathlib
import socket
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.common import as_f64, entry_device


@dataclass(frozen=True)
class Mesh:
    """A 1-D batch mesh: ``devices``, this process's devices in shard
    order; ``rank`` and ``world``, its place in the process group and the
    group's size (0 and 1 without one)."""
    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Shards in the mesh: every process's devices."""
        return self.world * len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device='cuda') -> Mesh:
    """A 1-D batch mesh of this process's first ``n_devices`` devices of
    ``device``'s type (all CUDA devices by default, raising without a
    card; on the CPU, ``n_devices`` virtual shards, default 1), across
    the processes of the group when ``torch.distributed`` is
    initialised.  In a group each process brings one card, its own
    (``torch.cuda.current_device()``, which :func:`initialize_distributed`
    selects by local rank), as NCCL takes one process a card."""
    dev = entry_device(device)
    if dev.type == 'cuda' and dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError('in a process group a mesh holds this '
                             "process's one card, got %d" % n_devices)
        devices = (torch.device('cuda', torch.cuda.current_device()),)
    elif dev.type == 'cuda':
        n_avail = torch.cuda.device_count()
        n = n_avail if n_devices is None else int(n_devices)
        if not 1 <= n <= n_avail:
            raise ValueError('a mesh of %d CUDA devices, %d present'
                             % (n, n_avail))
        devices = tuple(torch.device('cuda', i) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError('a mesh needs a device, got %d' % n)
        devices = (dev,) * n
    if dist.is_initialized():
        return Mesh(devices, dist.get_rank(), dist.get_world_size())
    return Mesh(devices)


def batch_sharding(mesh: Mesh, n: int) -> list:
    """The shards of a batch of ``n`` states over ``mesh``: [(rank,
    device, start, stop)] for each shard in order, the shard k of
    process k // len(devices) a contiguous block of ceil(n / size)
    states (the last ones shorter, or empty)."""
    per = -(-int(n) // mesh.size)
    nd = len(mesh.devices)
    return [(k // nd, mesh.devices[k % nd], min(n, k * per),
             min(n, (k + 1) * per)) for k in range(mesh.size)]


def pad_batch(n: int, divisor: int) -> int:
    """Round a batch size up to a multiple of ``divisor`` (the analog of
    the reference's padding to CUDA block multiples, pyjacob.cu:104-121).
    """
    return ((n + divisor - 1) // divisor) * divisor


def _local_shards(mesh: Mesh, n: int) -> list:
    """[(device, start, stop)] of this process's non-empty shards."""
    return [(dev, s, e) for r, dev, s, e in batch_sharding(mesh, n)
            if r == mesh.rank and e > s]


def _norm(mesh: Mesh, outs, per_shard: bool) -> torch.Tensor:
    """The JAX package's norm of the (J, f) pairs ``outs`` over every
    shard of every process: max|J| + max|f| over the whole batch
    (``sharded_step``), or with ``per_shard`` the largest of each
    shard's max|J| + max|f| (its dd steps sum on each shard, then take
    the ``pmax``).  This process's maxima, then ``all_reduce(MAX)`` over
    the group when ``torch.distributed`` is initialised (NCCL on the
    card, gloo on the CPU: :func:`initialize_distributed`)."""
    dev0 = mesh.devices[0]
    zero = torch.zeros((), dtype=torch.float64, device=dev0)
    top = lambda x: x.abs().max().to(dev0) if x.numel() else zero
    if per_shard:
        local = zero[None]
        for J, f in outs:
            local = torch.maximum(local, top(J) + top(f))
    else:
        local = zero.new_zeros(2)
        for J, f in outs:
            local = torch.maximum(local, torch.stack([top(J), top(f)]))
    if dist.is_initialized():
        dist.all_reduce(local, op=dist.ReduceOp.MAX)
    return local[0] if per_shard else local[0] + local[1]


def _sharded(mesh: Mesh, run, minor: bool = False,
             per_shard: bool = True):
    """A step over ``mesh``: ``run(device, y, param)`` -> (J, f) on each
    of this process's shards, on its device, joined along the batch axis
    on the first device, with their norm (:func:`_norm`).  Batch-major
    states y (B, N) and param (B,) or a scalar; with ``minor``,
    batch-minor y_t (N, B) and P_t (1, B)."""
    def step(y, param):
        y, param = as_f64(y), as_f64(param)
        if minor:
            B, N, axis = y.shape[-1], y.shape[0], -1
            cut = lambda x, s, e, dev: x[:, s:e].to(dev).contiguous()
        else:
            B, N, axis = y.shape[0], y.shape[-1], 0
            param = torch.broadcast_to(param, y.shape[:1])
            cut = lambda x, s, e, dev: x[s:e].to(dev)
        outs = [run(dev, cut(y, s, e, dev), cut(param, s, e, dev))
                for dev, s, e in _local_shards(mesh, B)]
        norm = _norm(mesh, outs, per_shard)
        dev0 = mesh.devices[0]
        if not outs:
            empty = lambda *shape: torch.empty(shape, dtype=y.dtype,
                                               device=dev0)
            return ((empty(N, N, 0), empty(N, 0), norm) if minor else
                    (empty(0, N, N), empty(0, N), norm))
        if len(outs) == 1:
            return tuple(x.to(dev0) for x in outs[0]) + (norm,)
        return tuple(torch.cat([x.to(dev0) for x in xs], axis)
                     for xs in zip(*outs)) + (norm,)
    return step


def _modules(mesh: Mesh, build) -> dict:
    """{device: build(device)} for each distinct device of the mesh."""
    return {dev: build(dev) for dev in dict.fromkeys(mesh.devices)}


def sharded_step(packed, mesh: Mesh, conp: bool = True):
    """A 'full step' over the mesh: the plain float64
    ``jacobian_and_dydt`` on each shard plus the cross-device error norm,
    as the JAX package's: max|J| + max|dy/dt| over the whole batch, each
    maximum reduced across devices (exactly).  ``step(y (B, N), param)``
    -> (J, f, norm) as this module's docstring describes."""
    from ..ops.jacobian import jacobian_and_dydt
    return _sharded(mesh, lambda dev, y, p: jacobian_and_dydt(
        packed, 0.0, p, y, conp=conp), per_shard=False)


def sharded_step_dd(packed, mesh: Mesh, conp: bool = True):
    """The parity-precision step over the mesh: the dense fused kernel
    K4 (``DenseJacobian.call_tr``; its plain version on the CPU) on each
    shard of batch-minor float64 states, plus the cross-device norm as
    the JAX package's: the largest of each shard's max|J| + max|f|.
    ``step(y_t (N, B), P_t (1, B))`` -> (Jt (N, N, b), f (N, b), norm)
    for this process's states b.  The JAX version also returns its VMEM
    tile; the port's tiles take any batch."""
    from ..ops.jacobian_dense import DenseJacobian
    mods = _modules(mesh, lambda dev: DenseJacobian(packed, conp=conp,
                                                    device=dev))
    return _sharded(mesh, lambda dev, y_t, P_t: mods[dev].call_tr(y_t, P_t),
                    minor=True)


def sharded_jacobian_dd_xla(packed, mesh: Mesh, conp: bool = True):
    """The JAX package's dd Jacobian math under ``shard_map``; here the
    native-float64 dense Jacobian, ``DenseJacobian`` (K4 on the card,
    its plain version on the CPU), on each shard of batch-major states,
    plus the cross-device norm, as the JAX version's: the largest of each
    shard's max|J| + max|f|.  ``step(y (B, N), param)`` -> (J, f,
    norm).  There is no double-float math, so the JAX version's
    ``n_dyn``, ``fast_trace`` and ``barriers`` have no counterpart."""
    from ..ops.jacobian_dense import DenseJacobian
    mods = _modules(mesh, lambda dev: DenseJacobian(packed, conp=conp,
                                                    device=dev))
    return _sharded(mesh, lambda dev, y, p: mods[dev](y, p))


def sharded_jacobian_dd_xla_sparse(packed, mesh: Mesh, conp: bool = True):
    """:func:`sharded_jacobian_dd_xla` with the headline pipeline:
    ``SparseJacobian`` (fused gather; the stage kernels K1 + K2 on the
    card, their plain versions on the CPU) on each shard, plus the
    cross-device norm of :func:`sharded_jacobian_dd_xla`.  ``step(y (B,
    N), param)`` -> (J, f, norm).  The JAX version's ``n_dyn``,
    ``fast_trace``, ``barriers`` and ``jit`` (XLA:CPU compile
    workarounds for the dd graph) have no counterpart."""
    from ..ops.jacobian_sparse import SparseJacobian
    mods = _modules(mesh, lambda dev: SparseJacobian(packed, conp=conp,
                                                     device=dev))
    return _sharded(mesh, lambda dev, y, p: mods[dev](y, p))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device='cuda') -> None:
    """Join the process group before building meshes: NCCL for CUDA
    ``device``s, gloo for the CPU.  ``coordinator_address`` is a
    ``host:port`` (or any ``init_method`` URL, ``tcp://`` or
    ``file://``); call once per process, with its rank ``process_id``
    among ``num_processes``.  On the card each process then takes the
    card of its local rank (``LOCAL_RANK``, as ``torchrun`` sets it, else
    its rank modulo the cards present), which :func:`make_mesh` gives
    its mesh.  No-op without an address or when a group is already
    initialised, as in the JAX package."""
    if coordinator_address is None or dist.is_initialized():
        return
    cuda = entry_device(device).type == 'cuda'
    url = coordinator_address if '://' in coordinator_address else \
        'tcp://' + coordinator_address
    dist.init_process_group('nccl' if cuda else 'gloo', init_method=url,
                            world_size=num_processes, rank=process_id)
    if cuda:
        torch.cuda.set_device(int(os.environ.get(
            'LOCAL_RANK', dist.get_rank() % torch.cuda.device_count())))


# ---------------------------------------------------------------------------
# the multi-process dry run
# ---------------------------------------------------------------------------

DRYRUN_STATES = 64


def _dryrun_worker(rank: int, n: int, address: str) -> None:
    """One process of :func:`dryrun_multichip`."""
    from ..ops.jacobian import jacobian_and_dydt
    from ..ops.jacobian_sparse import SparseJacobian
    from ..testers.synthetic import flagship

    torch.set_num_threads(1)
    initialize_distributed(address, n, rank, device='cpu')
    try:
        _, packed = flagship()
        data = pathlib.Path(__file__).resolve().parents[2] / 'tests' / 'data'
        d = np.load(data / 'flagship_states.npz')
        y = torch.as_tensor(d['y'][:DRYRUN_STATES])
        P = torch.as_tensor(d['P'][:DRYRUN_STATES])
        mesh = make_mesh(1, device='cpu')
        lo, hi = _local_shards(mesh, len(y))[0][1:]
        runs = (('sharded_step', sharded_step(packed, mesh),
                 lambda: jacobian_and_dydt(packed, 0.0, P, y)),
                ('sharded_jacobian_dd_xla_sparse',
                 sharded_jacobian_dd_xla_sparse(packed, mesh),
                 lambda: SparseJacobian(packed, device='cpu')(y, P)))
        for name, step, whole in runs:
            J, f, norm = step(y, P)
            parts = [None] * n if rank == 0 else None
            dist.gather_object((lo, hi, J, f, float(norm)), parts, dst=0)
            if rank:
                continue
            J0, f0 = whole()
            Js = torch.cat([p[2] for p in parts])
            fs = torch.cat([p[3] for p in parts])
            spans = [p[:2] for p in parts]
            # the JAX package's norms: over the batch, or the largest
            # shard's (its dd steps)
            top = lambda x: float(x.abs().max())
            want = (top(J0) + top(f0) if name == 'sharded_step' else
                    max(top(J0[s:e]) + top(f0[s:e]) for s, e in spans))
            if not (torch.equal(Js, J0) and torch.equal(fs, f0)):
                raise RuntimeError('%s: sharded J / f differ from the '
                                   'unsharded call: max |dJ| %.3e, |df| '
                                   '%.3e' % (name, float((Js - J0).abs()
                                                         .max()),
                                             float((fs - f0).abs().max())))
            if any(p[4] != want for p in parts):
                raise RuntimeError('%s: norms %s, the JAX package\'s is %r'
                                   % (name, [p[4] for p in parts], want))
            print('dryrun_multichip: %s over %d gloo processes, shards %s: '
                  'J %s, f equal to the unsharded call bit for bit, norm '
                  '%.6e on every process, max|J| + max|f| as the JAX '
                  'package\'s' % (name, n, spans, tuple(Js.shape), want),
                  flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> None:
    """The multi-device dry run on the CPU (the analog of
    ``__graft_entry__.dryrun_multichip``): ``n_devices`` gloo processes,
    one shard each, evaluate their shards of the first
    :data:`DRYRUN_STATES` flagship PaSR states of
    ``tests/data/flagship_states.npz`` through :func:`sharded_step` and
    :func:`sharded_jacobian_dd_xla_sparse`; rank 0 checks that the
    gathered J and dy/dt equal the unsharded call's bit for bit (every
    operation is per state; the plain versions' batched products on the
    CPU round alike where a shard holds a multiple of 16 states, as
    these do) and that every process's norm is the JAX package's:
    max|J| + max|f| over the batch for :func:`sharded_step`, the largest
    shard's for the dd step.  Raises if a process fails."""
    address = 'tcp://localhost:%d' % _free_port()
    torch.multiprocessing.spawn(_dryrun_worker, args=(n_devices, address),
                                nprocs=n_devices, join=True)


from .batch import BatchEvaluator  # noqa: E402,F401  (the JAX module's name)
