"""Functional (parity) test harness.

Port of ``pyjac_tpu/testers/functional.py`` (the rebuild of the
reference's functional tester, pyjac/functional_tester/test.py:1050-1615):
evaluate every intermediate — concentrations, forward/reverse rates,
pressure modifications, species rates, dy/dt, and the analytical
Jacobian — over a set of thermochemical states and compare against
independent oracles with the reference's error metrics (L2 / max
relative error over non-zero entries, 'zero-entry' absolute norms, and
the thresholded Jacobian error ignoring entries below ||J|| / 1e20;
reference: test.py:1331-1472).  Results are archived to
``error_arrays.npz`` (reference: test.py:1575-1579) under the JAX
package's keys.

Oracles (increasing independence), mirroring the reference's
Cantera / Adept / TChem triple:
  * the loop-based NumPy oracle (:mod:`.numpy_oracle`),
  * forward-mode AD of dydt (``jacobian_fwd``: ``torch.func.jacfwd`` in
    linear space — the card computes in IEEE f64, so the JAX package's
    log-space oracle, a workaround for the TPU's float32 exponent range,
    is not ported),
  * a finite-difference Jacobian of order 1/2/4/6 with CVODE-style
    perturbation sizing (port of reference fd_jacob.c:56-111 semantics).

The evaluations run on the CUDA card unless the caller asks for the CPU
(``device='cpu'``); the oracle loop and the metrics run on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..core.mech import Mechanism
from ..core.pack import PackedMechanism, pack
from ..ops.common import as_f64, entry_device
from . import numpy_oracle as oracle

# FD coefficients per order (reference: fd_jacob.c:19-53)
_FD_COEFFS = {
    1: ([1.0], [1.0]),
    2: ([-1.0, 1.0], [-0.5, 0.5]),
    4: ([-2.0, -1.0, 1.0, 2.0],
        [1.0 / 12.0, -2.0 / 3.0, 2.0 / 3.0, -1.0 / 12.0]),
    6: ([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0],
        [-1.0 / 60.0, 3.0 / 20.0, -3.0 / 4.0, 3.0 / 4.0, -3.0 / 20.0,
         1.0 / 60.0]),
}
_ATOL = 1e-15
_RTOL = 1e-8


def fd_jacobian(packed, t, param, y, conp: bool = True,
                order: int = 6) -> torch.Tensor:
    """Finite-difference Jacobian with CVODE-style perturbation sizing
    (reference: fd_jacob.c:56-111), vectorised over the batch.

    Runs the port's ``dydt`` where ``y`` lies (a tensor's device; an
    array runs on the CPU) and returns a float64 tensor there, (B, N, N)
    or (N, N) for one state."""
    from ..ops.dydt import dydt as dydt_fn

    x_c, y_c = _FD_COEFFS[order]
    y = as_f64(y)
    squeeze = y.dim() == 1
    if squeeze:
        y = y[None]
    B, N = y.shape
    param_b = torch.broadcast_to(as_f64(param, y.device), (B,))

    f0 = dydt_fn(packed, t, param_b, y, conp=conp)
    ewt = _ATOL + _RTOL * torch.abs(y)
    srur = float(np.sqrt(np.finfo(np.float64).eps))
    fac = torch.sqrt(torch.sum((ewt * f0) ** 2, dim=-1) / N)
    r0 = float(1000.0 * _RTOL * np.finfo(np.float64).eps * N) * fac

    J = torch.zeros((B, N, N), dtype=y.dtype, device=y.device)
    for j in range(N):
        r = torch.maximum(srur * torch.abs(y[:, j]), r0 / ewt[:, j])
        acc = torch.zeros((B, N), dtype=y.dtype, device=y.device)
        for xc, yc in zip(x_c, y_c):
            yp = y.clone()
            yp[:, j] = y[:, j] + xc * r
            fp = dydt_fn(packed, t, param_b, yp, conp=conp)
            if order == 1:
                acc = fp - f0
            else:
                acc = acc + yc * fp
        J[:, :, j] = acc / r[:, None]
    return J[0] if squeeze else J


@dataclass
class ErrorStats:
    """Per-state error metrics in the reference's format."""
    max_rel_nonzero: float
    l2_rel_nonzero: float
    l2_abs_zero: float
    max_rel_thresholded: Optional[float] = None
    l2_rel_thresholded: Optional[float] = None
    l2_norm_rel: Optional[float] = None


def _rel_errors(test: np.ndarray, ref: np.ndarray,
                threshold: Optional[float] = None) -> ErrorStats:
    """Reference metric semantics (test.py:1405-1472): relative error on
    entries where |test| is non-zero (vs the *reference* denominator),
    absolute L2 on entries where test == 0."""
    test = np.asarray(test).ravel()
    ref = np.asarray(ref).ravel()
    non_zero = np.where(test != 0.)[0]
    zero = np.where(test == 0.)[0]
    if non_zero.size:
        err = np.abs((test[non_zero] - ref[non_zero]) /
                     np.where(ref[non_zero] == 0, 1e-300, ref[non_zero]))
        max_rel = float(err.max())
        l2_rel = float(np.linalg.norm(err))
    else:
        max_rel = l2_rel = 0.0
    l2_zero = float(np.linalg.norm(test[zero] - ref[zero])) if zero.size \
        else 0.0
    stats = ErrorStats(max_rel, l2_rel, l2_zero)
    if threshold is not None:
        big = np.where(np.abs(test) > threshold)[0]
        if big.size:
            err = np.abs((test[big] - ref[big]) / ref[big])
            stats.max_rel_thresholded = float(err.max())
            stats.l2_rel_thresholded = float(np.linalg.norm(err))
        stats.l2_norm_rel = float(np.linalg.norm(test - ref) /
                                  max(np.linalg.norm(ref), 1e-300))
    return stats


def run_functional_test(mech: Mechanism, packed: Optional[PackedMechanism],
                        states: np.ndarray, conp: bool = True,
                        num_states: Optional[int] = None,
                        fd_order: int = 6,
                        out_file: Optional[str] = 'error_arrays.npz',
                        verbose: bool = True,
                        condition_numbers=None,
                        device='cuda') -> Dict[str, np.ndarray]:
    """Run the full parity suite over PaSR-style states.

    ``states`` rows are ``[t, T, P, Y_original_order...]`` (the PaSR
    dump layout, partially_stirred_reactor.py:877). Returns the error
    arrays (and writes them to ``out_file``), in the same spirit as
    reference test.py:1282-1587.  ``condition_numbers`` selects specific
    state rows for triage (reference test.py:1260-1262) and overrides
    ``num_states``.  The port's evaluations and its AD and FD oracles
    run on ``device`` (the CUDA card unless the caller asks for the
    CPU).
    """
    from ..ops import rates as rates_mod
    from ..ops import thermo as thermo_mod
    from ..ops.dydt import dydt as dydt_fn
    from ..ops.jacobian import eval_jacobian, jacobian_fwd

    device = entry_device(device)
    if packed is None:
        packed = pack(mech)
    states = np.asarray(states)
    if condition_numbers is not None:
        sel = [int(x) for x in condition_numbers]
        states = states[sel]
    elif num_states is not None:
        idx = np.linspace(0, len(states) - 1, num_states).astype(int)
        states = states[idx]
    n = len(states)

    T = states[:, 1]
    P = states[:, 2]
    Y_orig = states[:, 3:]
    Y = Y_orig[:, mech.fwd_spec_mapping]
    y = np.concatenate([T[:, None], Y[:, :-1]], axis=1)

    Tj, Pj, yj = (as_f64(a, device) for a in (T, P, y))
    Yj = as_f64(Y[:, :-1], device)

    _, _, rho, conc = thermo_mod.eval_conc(packed, Tj, Pj, Yj)
    fwd, rev = rates_mod.eval_rxn_rates(packed, Tj, Pj, conc)
    pm = rates_mod.get_rxn_pres_mod(packed, Tj, Pj, conc)
    wdot = rates_mod.eval_spec_rates(packed, fwd, rev, pm)
    param = Pj if conp else rho
    f = dydt_fn(packed, 0.0, param, yj, conp=conp)
    J = eval_jacobian(packed, 0.0, param, yj, conp=conp)
    J_ad = jacobian_fwd(packed, 0.0, param, yj, conp=conp)
    J_fd = fd_jacobian(packed, 0.0, param, yj, conp=conp, order=fd_order)

    rho, conc, fwd, rev, pm, wdot, f, J, J_ad, J_fd = (
        x.cpu().numpy() for x in (rho, conc, fwd, rev, pm, wdot, f, J,
                                  J_ad, J_fd))

    err = {k: np.zeros(n) for k in
           ('err_conc', 'err_fwd', 'err_rev', 'err_pres_mod',
            'err_spec_rates', 'err_dydt', 'err_dydt_zero', 'err_jac',
            'err_jac_max', 'err_jac_thr', 'err_jac_thr_max',
            'err_jac_norm', 'err_jac_zero', 'err_jac_fd')}

    for i in range(n):
        o = (oracle.evaluate(mech, T[i], P[i], Y[i, :-1]) if conp else
             oracle.evaluate_conv(mech, T[i], float(rho[i]), Y[i, :-1]))
        err['err_conc'][i] = _rel_errors(conc[i], o['conc']).max_rel_nonzero
        err['err_fwd'][i] = _rel_errors(fwd[i], o['fwd']).max_rel_nonzero
        err['err_rev'][i] = _rel_errors(rev[i], o['rev']).max_rel_nonzero
        err['err_pres_mod'][i] = _rel_errors(
            pm[i], o['pres_mod']).max_rel_nonzero

        # gross-flux scale for the cancelling net quantities
        gross = (o['pres_mod'] * (np.abs(o['fwd']) + np.abs(o['rev'])) @
                 np.abs(np.asarray(packed.nu_net)))
        wscale = gross.max() + 1e-300
        err['err_spec_rates'][i] = np.abs(
            wdot[i] - o['wdot']).max() / wscale

        s = _rel_errors(f[i], o['dydt'])
        err['err_dydt'][i] = s.l2_rel_nonzero
        err['err_dydt_zero'][i] = s.l2_abs_zero

        thr = np.linalg.norm(J[i]) / 1e20
        s = _rel_errors(J[i], J_ad[i], threshold=thr)
        err['err_jac'][i] = s.l2_rel_nonzero
        err['err_jac_max'][i] = s.max_rel_nonzero
        err['err_jac_thr'][i] = s.l2_rel_thresholded or 0.0
        err['err_jac_thr_max'][i] = s.max_rel_thresholded or 0.0
        err['err_jac_norm'][i] = s.l2_norm_rel or 0.0
        err['err_jac_zero'][i] = s.l2_abs_zero

        err['err_jac_fd'][i] = (np.linalg.norm(J[i] - J_fd[i]) /
                                max(np.linalg.norm(J_fd[i]), 1e-300))

        if verbose:
            print('state {:4d}/{}: T={:7.1f} K  jac thr max rel '
                  '{:.3e}  dydt L2 {:.3e}'.format(
                      i + 1, n, T[i], err['err_jac_thr_max'][i],
                      err['err_dydt'][i]))

    if out_file:
        np.savez(out_file, **err)
    if verbose:
        print('Maximum of thresholded Jacobian max rel error: '
              '{:.3e}'.format(err['err_jac_thr_max'].max()))
        print('Maximum dydt L2 relative error: {:.3e}'.format(
            err['err_dydt'].max()))
        print('Maximum FD-Jacobian norm difference: {:.3e}'.format(
            err['err_jac_fd'].max()))
    return err
