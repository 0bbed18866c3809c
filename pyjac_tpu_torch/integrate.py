"""Batched stiff ODE integration with the analytical Jacobian.

PyTorch port of ``pyjac_tpu/integrate.py``: the linearly implicit
Rosenbrock methods ROS23 (the ode23s method of Shampine & Reichelt 1997)
and RODAS3 (Sandu et al., as distributed with KPP), with a per-state
adaptive step, acceptance masks and status codes, over a batch of
thermochemical states.  The ``lax.while_loop`` of the JAX package is a
Python loop on device tensors here: each iteration is one attempted step
of every active state and reads the active count on the host once.  An
iteration computes a working set, not the whole batch: the active rows,
padded to the smallest size of :func:`ladder` (fixed by B) that holds
them.  When the active count fits a smaller size, the working set is
written back into the batch's arrays and gathered anew; finished rows
in it until then are masked as before.  On the card every kernel and op
computes a row alone, so a state ends where it ends at any size and
place in the working set.  On the CPU the plain paths' BLAS products sum
in an order that depends on the batch's size, so there a state's result
may depend on the working set's size at rounding level (~1e-10).

The stage Jacobian comes from the plain f64 ``eval_jacobian``
(``jacobian='xla'``, the JAX package's XLA path) or from
:class:`~pyjac_tpu_torch.ops.jacobian_dense.DenseJacobian`
(``jacobian='dd'``: the fused kernel K4 on the card, its plain version on
the CPU).  The iteration matrix ``W = I - h gamma J`` is factored once per
step and every stage solves with its factors: on the card, for N up to
``kernels.LU_MAX_N``, by the batched LU of ``csrc/batched_lu.cu``, which
forms W as it loads J; otherwise W is formed here and factored with
``torch.linalg.lu_factor_ex`` and solved with ``torch.linalg.lu_solve``.
The JAX package's ``gauss_solve`` (an elimination written because
XLA:TPU could not compile an f64 LU) is not ported.

The right-hand side f comes, on the card, from hand-written kernels for
every mechanism ``DenseJacobian`` takes: with ``jacobian='dd'`` a step's
f(y) is the f K4 returns beside J, and every other stage's f is one
launch of the dy/dt kernel (``csrc/dydt.cu``, K4's phases cut down to f,
its f equal to K4's bit for bit); with ``jacobian='xla'`` every f is the
dy/dt kernel's.  Elsewhere (on the CPU, or a mechanism
``DenseJacobian`` refuses under ``jacobian='xla'``) every f is the plain
``ops/dydt.py``.

While a profiler records, a call is one span ``pyjac.integrate`` holding
one ``pyjac.integrate.iteration`` a loop iteration, and each iteration
the spans ``pyjac.integrate.compact`` (a re-compaction of the working
set, where the iteration starts with one), ``.dydt`` (each dy/dt the loop
computes on its own, K4's f aside), ``.jacobian`` (the stage Jacobian),
``.lu_factor`` (``W`` and its factor), ``.lu_solve`` (each stage solve)
and ``.control`` (the error norm, the step controller and the masked
updates); ``profiling.counters`` gains the state rows the loop computed,
the working set's size each iteration, padding included
(``integrate.state_slots``), its re-compactions
(``integrate.compactions``), the steps its states took, accepted or
rejected (``integrate.state_attempts``), the factors the LU kernel took
(``integrate.lu_kernel``) and the dy/dts the dy/dt kernel took
(``integrate.dydt_kernel``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .ops.common import as_f64, entry_device
from .ops.dydt import dydt as dydt_dispatch
from .ops.jacobian import eval_jacobian
from .ops.jacobian_sparse import supports
from .ops import kernels
from .profiling import count, recording, span

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)

STATUS_SUCCESS = 0        # reached t_end
STATUS_UNDERFLOW = 1      # step size underflowed (stiff failure)
STATUS_BUDGET = 2         # per-state step budget exhausted mid-run
STATUS_STALLED = 3        # cut off by the global 2*max_steps backstop
#                           while its own attempt budget still had room


class IntegrateResult(NamedTuple):
    y: torch.Tensor          # (B, N) final states
    t: torch.Tensor          # (B,) final times (== t_end on success)
    steps: torch.Tensor      # (B,) accepted steps
    rejected: torch.Tensor   # (B,) rejected steps
    success: torch.Tensor    # (B,) bool
    status: torch.Tensor     # (B,) int32 STATUS_* code
    iterations: int          # loop iterations (attempted batch steps)


def lu_factor(J, s):
    """Factor the iteration matrices ``W_b = I - s_b J_b`` of the (B, N,
    N) stage Jacobians ``J`` (any strides: K4's (column, row, batch)
    output permuted, or a contiguous array) and the (B,) scales ``s``
    (h gamma).  Returns (LU, pivots, ok): ``ok`` (B,) is False where a
    pivot is exactly zero (a singular W), whose solves are then not
    finite, as are those of a non-finite W.  LU is (B, N, N) and the
    pivots (B, N) on either path: where :func:`kernels.lu_on_chip`, the
    kernel forms and factors W in one launch; elsewhere W is formed here
    and the library factors it."""
    if kernels.lu_on_chip(J):
        count('integrate.lu_kernel', 1)
        return tuple(torch.ops.pyjac_tpu_torch.lu_factor(J, s))
    eye = torch.eye(J.shape[-1], dtype=J.dtype, device=J.device)
    LU, piv, info = torch.linalg.lu_factor_ex(eye - s[:, None, None] * J,
                                              check_errors=False)
    return LU, piv, info == 0


def lu_solve(fac, rhs):
    """Solve W x = rhs, (B, N), with the factors of :func:`lu_factor`."""
    LU, piv, _ = fac
    if kernels.lu_on_chip(rhs):
        return torch.ops.pyjac_tpu_torch.lu_solve(LU, piv, rhs.contiguous())
    return torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]


def integrate(packed, y0, param, t_end, conp: bool = True,
              rtol: float = 1e-6, atol: float = 1e-10,
              max_steps: int = 100000, first_step: Optional[float] = None,
              jacobian: str = 'xla', method: str = 'ros23', device='cuda'):
    """Integrate dy/dt from 0 to ``t_end`` for a batch of states.

    ``y0`` is (B, N) states ``[T, Y_1..Y_{N-1}]``, ``param`` pressure
    (CONP) or density (CONV) per state, ``t_end`` a scalar or per-state
    array; every state adapts its own step size.  Runs on ``device``
    (the CUDA card unless the caller asks for the CPU).

    ``max_steps`` is a per-state attempt budget (accepted + rejected
    steps); a state that runs out reports ``STATUS_BUDGET``, one whose
    step underflows ``STATUS_UNDERFLOW``.  A global backstop of
    ``2 * max_steps`` iterations bounds the loop.

    ``jacobian='xla'`` evaluates the stage Jacobian with the plain f64
    ``eval_jacobian``; ``jacobian='dd'`` with ``DenseJacobian`` (K4 on
    the card, its plain version on the CPU).  There is no fallback: a
    mechanism ``DenseJacobian`` does not cover raises.

    ``method`` is ``'ros23'`` (3-stage order 2(3)) or ``'rodas3'``
    (4-stage order 3(2), stiffly accurate, L-stable).
    """
    if method not in ('ros23', 'rodas3'):
        raise ValueError('unknown method %r' % (method,))
    if jacobian not in ('xla', 'dd'):
        raise ValueError('unknown jacobian %r' % (jacobian,))
    device = entry_device(device)
    with span('pyjac.integrate'):
        return _integrate(packed, y0, param, t_end, conp, rtol, atol,
                          max_steps, first_step, jacobian, method, device)


# the smallest working set: below it an iteration's kernels (K4, the LU
# factor, 3 solves, 2 dy/dt) take no less time on the card, ~0.28 ms at
# the 53-species flagship from 8 rows to 256 (``probes/working_set_rows.py``)
FLOOR_ROWS = 256


def ladder(B: int) -> tuple:
    """The working-set sizes of the loop over a batch of B states, largest
    first: B, the multiples of ceil(B / 8) below it, then that step's
    halvings, none under :data:`FLOOR_ROWS` (B where B is smaller).  At
    most 1/8 of B is padding while the card is busy, at most half in the
    tail, where the kernels are latency-bound; a function of B alone, so
    a call sees few shapes (12 at B = 32768)."""
    floor = min(B, FLOOR_ROWS)
    step = -(-B // 8)
    sizes = {B, floor} | {k * step for k in range(1, 8)} | \
        {step >> j for j in range(1, step.bit_length())}
    return tuple(sorted((s for s in sizes if floor <= s <= B), reverse=True))


def _integrate(packed, y0, param, t_end, conp, rtol, atol, max_steps,
               first_step, jacobian, method, device):
    y0 = as_f64(y0, device)
    B = y0.shape[0]
    param = torch.broadcast_to(as_f64(param, device), (B,)).contiguous()
    t_end = torch.broadcast_to(as_f64(t_end, device), (B,))

    # f by the dy/dt kernel: on the card, for the mechanisms K4 takes
    kernel_f = y0.device.type == 'cuda' and supports(packed)
    if jacobian == 'dd' or kernel_f:
        from .ops.jacobian_dense import DenseJacobian
        dense = DenseJacobian(packed, conp=conp, device=device)

    # f and J of the working set's (W, N) states y at their (W,)
    # pressures/densities prm, contiguous: prm[None] is the kernels' row
    def f(y, prm):
        with span('pyjac.integrate.dydt'):
            if kernel_f:
                count('integrate.dydt_kernel', 1)
                # (N, W) views of the (W, N) states and of f: no copy
                return kernels.dydt(dense, y.T, prm[None]).T
            return dydt_dispatch(packed, 0.0, prm, y, conp=conp)

    if jacobian == 'dd':
        def jac(y, prm):
            Jt, fk = dense.call_tr(y.T.contiguous(), prm[None])
            # kernel layout (column, row, batch) -> (batch, row, column);
            # K4's f is f(y) where the dy/dt kernel would give it
            return Jt.permute(2, 1, 0), (fk.T if kernel_f else None)
    else:
        def jac(y, prm):
            return eval_jacobian(packed, 0.0, prm, y, conp=conp), None

    if first_step is None:
        h = t_end * 1e-6
    else:
        h = torch.full((B,), first_step, dtype=y0.dtype, device=device)
    gamma = _D if method == 'ros23' else 0.5

    # The working set: the loop state of the rows each iteration
    # computes, their rows in the batch, and each row's horizon te and
    # parameter prm.  It starts as the whole batch.  When the active
    # states fit a smaller size of the ladder, it is written into the
    # batch's arrays (out of place: y0 is the caller's) and gathered
    # anew: the active rows first, then inactive ones to pad it to that
    # size, which their masked updates leave as they are.  h is not
    # written back: a row left out is done for good.
    t = torch.zeros((B,), dtype=y0.dtype, device=device)
    steps = torch.zeros((B,), dtype=torch.int32, device=device)
    rejected = torch.zeros((B,), dtype=torch.int32, device=device)
    failed = torch.zeros((B,), dtype=torch.bool, device=device)
    batch = (y0, t, steps, rejected, failed)
    y = y0
    rows = torch.arange(B, device=device)
    te, prm = t_end, param
    sizes = ladder(B)
    iters = 0
    active = (t < te) & ~failed & (steps + rejected < max_steps)
    n_active = int(active.sum())
    while n_active and iters < 2 * max_steps:
        with span('pyjac.integrate.iteration'):
            size = min(s for s in sizes if s >= n_active)
            if size < y.shape[0]:
                with span('pyjac.integrate.compact'):
                    count('integrate.compactions', 1)
                    state = (y, t, steps, rejected, failed)
                    batch = tuple(a.index_copy(0, rows, w)
                                  for a, w in zip(batch, state))
                    # the active rows first, in order, with no host sync
                    sel = torch.argsort(~active, stable=True)[:size]
                    rows = rows[sel]
                    y, t, steps, rejected, failed, h, te, prm, active = (
                        a[sel] for a in state + (h, te, prm, active))
            count('integrate.state_slots', y.shape[0])
            hs = torch.minimum(h, te - t)
            # a benign step on the rows of finished states
            hs = torch.where(active, hs, 1.0)

            with span('pyjac.integrate.jacobian'):
                J, F0 = jac(y, prm)
            if F0 is None:
                F0 = f(y, prm)
            with span('pyjac.integrate.lu_factor'):
                fac = lu_factor(J, hs * gamma)

            def solve(rhs):
                with span('pyjac.integrate.lu_solve'):
                    return lu_solve(fac, rhs)

            if method == 'ros23':
                k1 = solve(F0)
                F1 = f(y + 0.5 * hs[:, None] * k1, prm)
                k2 = solve(F1 - k1) + k1
                y_new = y + hs[:, None] * k2
                F2 = f(y_new, prm)
                k3 = solve(F2 - _E32 * (k2 - F1) - 2.0 * (k1 - F0))
                err_vec = (hs / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)
            else:
                # RODAS3 in the KPP stage form: (I - h g J) K_i =
                # h g F(Y_i) + g sum_j C_ij K_j, with gamma = 1/2,
                # A = [[0],[2,0],[2,0,1]], C = [[4],[1,-1],[1,-1,-8/3]],
                # M = [2,0,1,1], E = [0,0,0,1]; stage 2 reuses F(y).
                hc = hs[:, None]
                K1 = solve(0.5 * hc * F0)
                K2 = solve(0.5 * hc * F0 + 2.0 * K1)
                Y3 = y + 2.0 * K1
                K3 = solve(0.5 * (hc * f(Y3, prm) + K1 - K2))
                Y4 = Y3 + K3
                K4 = solve(0.5 * (hc * f(Y4, prm) + K1 - K2)
                           - (4.0 / 3.0) * K3)
                y_new = y + 2.0 * K1 + K3 + K4
                err_vec = K4

            with span('pyjac.integrate.control'):
                scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
                err = torch.sqrt(torch.mean((err_vec / scale) ** 2, dim=-1))
                err = torch.where(torch.isfinite(err) & fac[2], err,
                                  math.inf)

                accept = (err <= 1.0) & active
                # PI-less step controller with the usual safety factors
                factor = torch.clamp(
                    0.9 * torch.pow(torch.clamp(err, min=1e-16), -1.0 / 3.0),
                    0.2, 5.0)
                h_next = torch.where(accept, hs * factor,
                                     hs * torch.clamp(factor, min=0.2) * 0.5)
                h_next = torch.where(torch.isfinite(h_next) & (h_next > 0.0),
                                     h_next, hs * 0.5)

                y = torch.where(accept[:, None], y_new, y)
                t = torch.where(accept, t + hs, t)
                # a step that underflows the representable dt is a failure
                too_small = active & (h_next < 1e-14 * te) & ~accept
                h = torch.where(active, h_next, h)
                steps = steps + accept.to(torch.int32)
                rejected = rejected + (active & ~accept).to(torch.int32)
                failed = failed | too_small
            iters += 1
            active = (t < te) & ~failed & (steps + rejected < max_steps)
            n_active = int(active.sum())   # the iteration's one host sync

    y, t, steps, rejected, failed = (
        a.index_copy(0, rows, w)
        for a, w in zip(batch, (y, t, steps, rejected, failed)))
    success = (t >= t_end) & ~failed
    att = steps + rejected
    status = torch.where(
        success, STATUS_SUCCESS,
        torch.where(failed, STATUS_UNDERFLOW,
                    torch.where(att >= max_steps, STATUS_BUDGET,
                                STATUS_STALLED))).to(torch.int32)
    if recording():
        count('integrate.state_attempts', int(att.sum()))
    return IntegrateResult(y, t, steps, rejected, success, status, iters)


def ignition_delay(packed, y0, param, t_end, threshold: float = 400.0,
                   conp: bool = True, n_points: int = 64,
                   rtol: float = 1e-6, atol: float = 1e-10,
                   jacobian: str = 'xla', device='cuda'):
    """Crude batched ignition-delay estimate: bisection on the time at
    which T rises ``threshold`` K above the initial temperature (the
    JAX package's bisection, each probe one :func:`integrate` call, its
    stage Jacobian by ``jacobian``: 'dd' runs K4 on the card).
    Returns a (B,) numpy array of times."""
    device = entry_device(device)
    y0 = as_f64(y0, device)
    T0 = y0[:, 0].cpu().numpy()
    lo = np.zeros(len(T0))
    hi = np.full(len(T0), float(t_end))
    for _ in range(int(math.log2(n_points)) + 4):
        mid = 0.5 * (lo + hi)
        res = integrate(packed, y0, param, mid, conp=conp, rtol=rtol,
                        atol=atol, jacobian=jacobian, device=device)
        ignited = res.y[:, 0].cpu().numpy() > T0 + threshold
        hi = np.where(ignited, mid, hi)
        lo = np.where(ignited, lo, mid)
    return 0.5 * (lo + hi)
