"""Profiling and cost accounting on the H100.

PyTorch port of ``pyjac_tpu/profiling.py`` (the reference's
observability is a wall-clock timer and CSV lines, reference:
pyjac/performance_tester/timer.h:24-53, tester.c.in:31):

* :func:`trace` — ``torch.profiler`` around a block of work, the card's
  activity included where there is one, written as a Chrome trace;
* :func:`span` and :func:`count` — the port's own named ranges and
  counters, recorded only while a profiler records (a :func:`trace`
  block, or any ``torch.profiler.profile``): the ranges land in its
  trace on the clock of the card's records, the counts in
  :data:`counters`;
* :func:`cost_estimate` — the JAX package's closed-form operation /
  byte count per kernel per state, from the packed mechanism;
* :func:`speed_of_light` — the roofline throughput of that count at this
  card's float64 peaks (:data:`HBM_BYTES_S`, :data:`F64_FLOP_S`);
* :func:`timed` — seconds per call, by CUDA events on the card and by
  the host clock after a sync elsewhere;
* :func:`roofline` — the least time of each port kernel (K1-K7, K2x) a
  module runs on B states: the bytes it must move (each input read once,
  each output written once) and the operations its data needs, counted
  from the module's tables and the outputs' shapes alone, so it runs on
  the CPU.  ``chip_smoke.py`` reports each kernel's ``bound_ms`` from it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from .ops.common import _tracing

# NVIDIA H100 SXM peaks (the data sheet; they assume the 700 W power
# limit): HBM3 bandwidth; FP64 outside the tensor cores (no port kernel
# issues DMMA, so the 67 TFLOP/s FP64 tensor-core rate does not apply);
# FP32 outside the tensor cores (K3)
HBM_BYTES_S = 3.35e12
F64_FLOP_S = 34e12
F32_FLOP_S = 67e12
# operations one exp / log / log10 / pow counts for in a bound: a
# polynomial of degree ~10 after range reduction, in f64 and f32 alike
TRANSCENDENTAL_OPS = 20


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of work into ``log_dir`` as a Chrome trace
    (``trace.json``), with the card's activity where there is a card.
    Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` give the time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


# the port's counts while a profiler records (:func:`count`):
# ``integrate.state_slots``, the state rows the integrator's loop
# computed (its working sets, padding included);
# ``integrate.compactions``, the loop's re-compactions of its working
# set; ``integrate.state_attempts``, the steps (accepted or
# rejected) its states took; ``integrate.lu_kernel``, the factors the
# LU kernel (csrc/batched_lu.cu) took; ``integrate.dydt_kernel``, the
# dy/dts the dy/dt kernel (csrc/dydt.cu) took
counters: Dict[str, int] = {}

_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records and no tracer
    (``torch.export``, ``torch.compile``) runs the caller."""
    return torch.autograd._profiler_enabled() and not _tracing()


def span(name: str):
    """A context naming the block it encloses in the profiler's trace
    (``with span('pyjac.integrate.dydt'): ...``): a ``record_function``
    while :func:`recording`, else one shared null context, so that with
    no profiler a span costs a flag check and under a tracer an exported
    graph holds no profiler op.  The port's spans: ``pyjac.jacobian``
    (a Jacobian module's ``call_tr``), ``pyjac.kernels.{prepare, plan,
    alloc, launch}`` (each launcher), ``pyjac.integrate`` and its loop's
    ``pyjac.integrate.{iteration, dydt, jacobian, lu_factor, lu_solve,
    control}``."""
    if recording():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int) -> None:
    """Add ``n`` to ``counters[name]`` while :func:`recording`, so that
    the counts cover what the spans cover."""
    if recording():
        counters[name] = counters.get(name, 0) + int(n)


@dataclass
class CostEstimate:
    flops_per_state: float
    transcendentals_per_state: float
    bytes_per_state: float

    def arithmetic_intensity(self) -> float:
        return self.flops_per_state / max(self.bytes_per_state, 1.0)


def cost_estimate(packed, kernel: str = 'jacobian',
                  dtype_bytes: int = 8) -> CostEstimate:
    """Analytic per-state cost of a kernel for roofline analysis (the
    JAX package's closed form, number for number)."""
    N = packed.n_species
    R = packed.n_reactions
    Sf = packed.reac_sp.shape[1]
    Sp = packed.prod_sp.shape[1]

    # rates: kf/Kc exponentials, slot products, nu^T q matmul
    trans = 3.0 * R                      # exp(kf), exp(Kc), assorted logs
    flops_rates = R * (10 + 3 * (Sf + Sp)) + 2.0 * R * N   # + spec matmul
    bytes_rates = (N + 4 * R) * dtype_bytes

    if kernel == 'rates':
        return CostEstimate(flops_rates, trans, bytes_rates)
    if kernel == 'dydt':
        return CostEstimate(flops_rates + 8.0 * N, trans + 2 * N,
                            bytes_rates + 2 * N * dtype_bytes)
    if kernel == 'jacobian':
        # dominant: dense nu^T @ P1 matmul (N x R)(R x N-1) plus the
        # O(R N) P1/D assembly and O(R) scalar derivative terms
        flops = (flops_rates + 2.0 * R * N * (N - 1) + 10.0 * R * N +
                 40.0 * R + 8.0 * N * N)
        bytes_ = (3.0 * R * N + N * N + 6 * R) * dtype_bytes
        return CostEstimate(flops, trans + 4.0 * R, bytes_)
    raise ValueError('unknown kernel ' + kernel)


def speed_of_light(packed, kernel: str = 'jacobian',
                   dtype_bytes: int = 8,
                   peak_flops: float = F64_FLOP_S,
                   peak_bw: float = HBM_BYTES_S) -> Dict[str, float]:
    """Upper-bound throughput (evals/s) from the roofline model.

    Defaults: one H100 SXM in float64 (:data:`F64_FLOP_S`,
    :data:`HBM_BYTES_S`); pass :data:`F32_FLOP_S` and ``dtype_bytes=4``
    for float32.
    """
    c = cost_estimate(packed, kernel, dtype_bytes)
    return {
        'compute_bound_evals_per_sec': peak_flops / c.flops_per_state,
        'memory_bound_evals_per_sec': peak_bw / c.bytes_per_state,
        'arithmetic_intensity': c.arithmetic_intensity(),
    }


def _leaves(res):
    return res if isinstance(res, (tuple, list)) else (res,)


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1):
    """(result, seconds per call) of ``fn(*args)``: the mean over
    ``iters`` queued calls after ``warmup`` untimed ones.  Where the
    result lies on a CUDA device, CUDA events on its current stream time
    the calls; elsewhere the host clock does, after a sync on the
    result (its first element read back)."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args)
    dev = next((x.device for x in _leaves(result)
                if isinstance(x, torch.Tensor)), torch.device('cpu'))
    if dev.type == 'cuda':
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(dev):
            start.record()
            for _ in range(iters):
                result = fn(*args)
            end.record()
        end.synchronize()
        return result, start.elapsed_time(end) * 1e-3 / iters

    def sync(res):
        return sum(float(torch.as_tensor(x).reshape(-1)[0])
                   for x in _leaves(res))

    sync(result)
    t0 = time.perf_counter()
    for _ in range(iters):
        result = fn(*args)
        sync(result)
    return result, (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# the port kernels' roofline
# ---------------------------------------------------------------------------

def bound(n_bytes: float, n_ops: float = 0.0,
          flop_s: float = F64_FLOP_S) -> dict:
    """The least time of moving ``n_bytes`` through HBM once and doing
    ``n_ops`` operations at ``flop_s``: {bytes, operations, bound_ms,
    bound_by ('bytes' or 'operations')}."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    to = n_ops / flop_s * 1e3
    return {'bytes': float(n_bytes), 'operations': float(n_ops),
            'bound_ms': max(tb, to),
            'bound_by': 'bytes' if tb >= to else 'operations'}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _transcendental_calls(mod) -> float:
    """The exp / log / pow calls a state's reactions make in K4 / K3 and
    the dy/dt kernel (``mod``: a ``DenseJacobian`` or an
    ``F32Jacobian``): kf; Kc's exp when reversible; the low- or
    high-pressure rate and log10 Pr under falloff; Troe's 4 (5 with T2);
    SRI's 7 (2 exp, 2 pow at 2 each, a log); PLOG's and Chebyshev's 2; 4
    a slot with fractional nu."""
    fl = mod.kp_flags.cpu().numpy()
    plog = (mod.kp_plog_pos >= 0).cpu().numpy()
    cheb = (mod.kp_cheb_pos >= 0).cpu().numpy()
    p = mod.packed
    calls = (1 + (fl & 1 != 0) + 2 * (fl & (4 | 8) != 0) +
             (fl & 16 != 0) * (4 + (fl & 64 != 0)) + 7 * (fl & 32 != 0) +
             2 * plog + 2 * cheb).sum()
    if p.has_frac_nu:
        calls += 4 * mod.R * (p.reac_sp.shape[1] + p.prod_sp.shape[1])
    return float(calls)


def dense_ops(mod, B: int) -> float:
    """The operations K4 / K3 (``mod``: a ``DenseJacobian`` or an
    ``F32Jacobian``) needs for B states, counted from its tables: per
    state the thermo (ln T, 50 per species), per reaction 40, 4 per entry
    of its Kc sum and the exp / log / pow calls its categories make
    (:data:`TRANSCENDENTAL_OPS` each: kf; Kc's exp when reversible; the
    low- or high-pressure rate and log10 Pr under falloff; Troe's 4 (5
    with T2); SRI's 7 (2 exp, 2 pow at 2 each, a log); PLOG's and
    Chebyshev's 2; 4 a slot with fractional nu), the contractions (8 per
    nu_net entry: four sums of products), the closure (12 per species),
    the column operand's products (2 per CSR entry) and ``_post_col`` (8
    per J entry)."""
    p = mod.packed
    N, R, J = mod.N, mod.R, mod.N - 1
    nnz = int((np.asarray(p.nu_net) != 0).sum())
    per_state = (TRANSCENDENTAL_OPS * (1 + _transcendental_calls(mod)) +
                 50.0 * N + 40.0 * R + 4.0 * int(mod.kp_nu_ptr[-1]) +
                 8.0 * nnz + 12.0 * N + 2.0 * mod.kf_col_coef.numel() +
                 8.0 * J * N)
    return per_state * B


def dydt_ops(mod, B: int) -> float:
    """The operations the dy/dt kernel (``csrc/dydt.cu``) needs for B
    states on the tables of ``mod`` (a ``DenseJacobian``), counted as
    :func:`dense_ops` counts K4's, less what f does not need: per state
    the thermo (ln T, 50 per species), per reaction 20 (the rate
    constants, the concentration products, the pressure modification and
    q), 2 per entry of its Kc sum and its transcendental calls, the
    contraction (2 per nu_net entry: one sum of products) and the closure
    (6 per species)."""
    p = mod.packed
    N, R = mod.N, mod.R
    nnz = int((np.asarray(p.nu_net) != 0).sum())
    per_state = (TRANSCENDENTAL_OPS * (1 + _transcendental_calls(mod)) +
                 50.0 * N + 20.0 * R + 2.0 * int(mod.kp_nu_ptr[-1]) +
                 2.0 * nnz + 6.0 * N)
    return per_state * B


def _column_bound(operand_rows, post_rows, tabs, J, N, B) -> dict:
    """A column kernel's bound (K2, K2x, K6): the operand and the post
    rows read, its tables ``tabs`` = (ptr, src, coef, 1/W) read, the
    (J, N, B) columns written; per CSR entry a product and a sum, per J
    entry ``_post_col``'s 8 operations."""
    moved = (8 * (operand_rows + post_rows) * B + _nbytes(*tabs) +
             8 * J * N * B)
    return bound(moved, 2 * tabs[2].numel() * B + 8 * J * N * B)


def _dense_products(mod, B: int) -> float:
    """The nonzero products K7 needs for B states (``mod``: a
    ``BigJacobian(sparse_cols=False)``): per column, the reactions whose
    operand is nonzero there times the nonzero nu_net entries of each."""
    td = mod.tab('kd_')
    J = mod.J
    cols = torch.arange(J, device=td['spf'].device)
    part = ((td['spf'][:, :, None] == cols).any(1) |
            (td['spp'][:, :, None] == cols).any(1) |
            (td['eff'][:, :J] != 0) | (td['pd'][:, None] == cols))
    nnz = (td['nu_net'] != 0).sum(1)
    return float((part.double() * nnz[:, None]).sum()) * B


def roofline(mod, B: int) -> Dict[str, dict]:
    """{kernel: :func:`bound` row} for each port kernel ``mod`` runs on
    B states, by its launch counter's name (``kernels.launches``):

    * ``SparseJacobian``: K1 ``stage_a`` (states, its tables, and its
      outputs src, col0, f, post: bytes only),
      then K2 ``stage_b`` (``fuse_gather``) or K2x ``stage_b_x`` (the
      gathered operand, J x Rmax rows);
    * ``DenseJacobian``: K4 ``dense_fused`` (states, tables, J and f;
      :func:`dense_ops` at :data:`F64_FLOP_S`), and the dy/dt kernel
      ``dydt`` on its tables (states, the tables K4's phases 0-4 read,
      f; :func:`dydt_ops`); ``F32Jacobian``: K3
      ``fused_f32``, the same in float32 at :data:`F32_FLOP_S`;
    * ``BigJacobian``: K5 ``big_parts`` (the pre-stage rows, its
      tables, the role array), then K6 ``big_cols_sparse`` or K7
      ``big_cols_dense`` (the slot, q and c_1 role rows and the post
      rows read, its tables, 2 operations a nonzero product of
      :func:`_dense_products`).

    Counted from the tables each kernel's launch passes (the gatherers
    of :mod:`.ops.kernels`) and the outputs' shapes, with no kernel run,
    so it runs on any device."""
    from .ops import kernels
    from .ops.jacobian_big import BigJacobian
    from .ops.jacobian_dense import DenseJacobian
    from .ops.jacobian_f32 import F32Jacobian
    from .ops.jacobian_sparse import SparseJacobian
    if not isinstance(mod, (SparseJacobian, DenseJacobian, F32Jacobian,
                            BigJacobian)):
        raise TypeError('no port kernel runs in %s' % type(mod).__name__)
    N, J = mod.N, mod.J
    if isinstance(mod, SparseJacobian):
        n_out = mod.n_src + 2 * N + mod.n_post
        rows = {'stage_a': bound(8 * (N + 1 + n_out) * B + _nbytes(
            *kernels.stage_a_inputs(mod)[0]))}
        if mod.fuse_gather:
            rows['stage_b'] = _column_bound(
                mod.n_src, mod.n_post, kernels.stage_b_inputs(mod)[0], J, N,
                B)
        else:
            rows['stage_b_x'] = _column_bound(
                J * mod.Rmax, mod.n_post,
                kernels.cols_sparse_inputs(mod, 'kx_')[0], J, N, B)
        return rows
    if isinstance(mod, (DenseJacobian, F32Jacobian)):
        f32 = isinstance(mod, F32Jacobian)
        item = 4 if f32 else 8
        tabs = kernels.dense_inputs(mod, torch.float32 if f32 else
                                    torch.float64)[0]
        moved = item * (N + 1 + N * N + N) * B + _nbytes(*tabs)
        rows = {'fused_f32' if f32 else 'dense_fused': bound(
            moved, dense_ops(mod, B), F32_FLOP_S if f32 else F64_FLOP_S)}
        if not f32:
            # the column CSR, which only K4's phase 5 reads
            unread = (mod.kf_col_coef, mod.kf_col_src, mod.kf_col_order)
            read = [t for t in tabs if all(t is not u for u in unread)]
            rows['dydt'] = bound(8 * (2 * N + 1) * B + _nbytes(*read),
                                 dydt_ops(mod, B))
        return rows
    R = mod.R
    rows = {'big_parts': bound(
        8 * ((5 + 3 * N) + mod.n_roles * R) * B +
        _nbytes(*kernels.parts_inputs(mod)[0]))}
    if mod.sparse_cols:
        rows['big_cols_sparse'] = _column_bound(
            J * mod.Rmax, mod.n_post,
            kernels.cols_sparse_inputs(mod, 'ks_')[0], J, N, B)
    else:
        moved = (8 * ((mod.Sf + mod.Sp + 2) * R + mod.n_post) * B +
                 _nbytes(*kernels.cols_dense_inputs(mod)[0]) +
                 8 * J * N * B)
        rows['big_cols_dense'] = bound(moved, 2.0 * _dense_products(mod, B))
    return rows
