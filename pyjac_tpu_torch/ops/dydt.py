"""State derivative dy/dt under constant pressure (CONP) or constant
volume (CONV), batched over states.

PyTorch counterpart of ``pyjac_tpu/ops/dydt.py`` (reference:
pyjac/core/rate_subs.py:2093-2490 ``write_derivs``).

State layout matches the reference exactly: ``y = [T, Y_1 .. Y_{N-1}]``
with the last species eliminated via ``Y_N = 1 - sum(Y)``; shape
``(..., N)`` float64.  The second argument is pressure [Pa] for CONP
and density [kg/m^3] for CONV, broadcastable against the batch.
"""

from __future__ import annotations

import torch

from .common import as_f64, to_device
from .rates import eval_rxn_rates, eval_spec_rates, get_rxn_pres_mod
from .thermo import (eval_conc, eval_conc_rho, eval_cp, eval_cv, eval_h,
                     eval_u)


def split_state(y):
    """(T, Y_reduced) from a packed state vector."""
    return y[..., 0], y[..., 1:]


def _param(param, y):
    return torch.broadcast_to(as_f64(param, y.device), y.shape[:-1])


def dydt_conp(packed, t, pres, y):
    """dy/dt at constant pressure (reference: rate_subs.py:2171-2335).

    dT/dt = -(1 / (rho cp_bar)) sum_k h_k W_k omega_k
    dY_k/dt = omega_k W_k / rho
    """
    T, Y = split_state(y)
    pres = _param(pres, y)
    y_N, mw_avg, rho, conc = eval_conc(packed, T, pres, Y)
    fwd, rev = eval_rxn_rates(packed, T, pres, conc)
    pm = get_rxn_pres_mod(packed, T, pres, conc)
    wdot = eval_spec_rates(packed, fwd, rev, pm)          # (..., N)

    cp = eval_cp(packed, T)                                # (..., N)
    y_full = torch.cat([Y, y_N[..., None]], dim=-1)
    cp_avg = torch.sum(cp * y_full, dim=-1)
    h = eval_h(packed, T)

    mw = to_device(packed, y.device).mw
    dT = -torch.sum(h * mw * wdot, dim=-1) / (rho * cp_avg)
    dY = wdot[..., :-1] * mw[:-1] / rho[..., None]
    return torch.cat([dT[..., None], dY], dim=-1)


def dydt_conv(packed, t, rho, y):
    """dy/dt at constant volume (reference: rate_subs.py:2337-2487).

    dT/dt = -(1 / (rho cv_bar)) sum_k u_k W_k omega_k
    """
    T, Y = split_state(y)
    rho = _param(rho, y)
    y_N, mw_avg, pres, conc = eval_conc_rho(packed, T, rho, Y)
    fwd, rev = eval_rxn_rates(packed, T, pres, conc)
    pm = get_rxn_pres_mod(packed, T, pres, conc)
    wdot = eval_spec_rates(packed, fwd, rev, pm)

    cv = eval_cv(packed, T)
    y_full = torch.cat([Y, y_N[..., None]], dim=-1)
    cv_avg = torch.sum(cv * y_full, dim=-1)
    u = eval_u(packed, T)

    mw = to_device(packed, y.device).mw
    dT = -torch.sum(u * mw * wdot, dim=-1) / (rho * cv_avg)
    dY = wdot[..., :-1] * mw[:-1] / rho[..., None]
    return torch.cat([dT[..., None], dY], dim=-1)


def dydt(packed, t, param, y, conp: bool = True):
    """Dispatch to :func:`dydt_conp` or :func:`dydt_conv` (the reference's
    compile-time CONP/CONV switch, mech_auxiliary.py:464-466)."""
    if conp:
        return dydt_conp(packed, t, param, y)
    return dydt_conv(packed, t, param, y)
