"""Closed-form analytical Jacobian d(dy/dt)/dy, batched over states.

PyTorch counterpart of ``pyjac_tpu/ops/jacobian.py`` and the port's
plain float64 path: every kernel of the port is checked against it
(reference: pyjac/core/create_jacobian.py:2189-3277 ``write_jacobian``;
dT terms :1135-1851, species terms :127-489, finishing passes
:3109-3254 and :1853-1905).

Mathematical structure: every reaction's rate of progress
``q = pm (Rf - Rr)`` is differentiated once w.r.t. temperature and once
w.r.t. each species concentration; with

    dC_m/dY_j = C_m r_j + (rho/W_j) d_mj - (rho/W_N) d_mN

the species block becomes

    domega/dY = nu_net^T @ P1  +  (nu_net^T c_u) u^T + (nu_net^T c_1) 1^T

one dense contraction plus two outer products.  Temperature and
pressure dependence enter through per-reaction scalar log-derivatives
(Arrhenius, PLOG interval weights, Chebyshev derivative polynomials,
Troe/SRI blending factors).

:func:`reaction_parts` returns the per-reaction section on its own so
the sparse pipeline's plain version (``ops/jacobian_sparse.py``) shares
this exact math.

The result is laid out like the reference's: ``J[..., i, j] =
d f_i / d y_j`` with ``y = [T, Y_1..Y_{N-1}]`` and ``f = dy/dt``;
row/column 0 is the temperature equation.  ``jacobian_fwd``
(``torch.func.jacfwd`` of dydt) is the built-in oracle — the analog of
the reference's Adept autodiff check (mech_auxiliary.py:56-79).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import RU
from .common import LOG10, TINY, as_f64, to_device
from .dydt import dydt as dydt_dispatch
from .rates import _LN_PA_RU, _arrhenius, _plog_interval, _take_last
from .thermo import (eval_cp, eval_cv, eval_dcp_dT, eval_dsmh_dT, eval_h,
                     eval_smh, eval_u)


# ---------------------------------------------------------------------------
# forward rate constant with log-derivatives
# ---------------------------------------------------------------------------

def _kf_with_derivs(packed, T, logT, pres):
    """(kf, dln kf/dT |_P, dln kf/dln P), each (..., R)."""
    t = to_device(packed, T.device)
    Tb = T[..., None]
    kf = _arrhenius(t.logA, t.beta, t.Ta, T, logT)
    if packed.has_negative_A:
        kf = kf * t.A_sign
    dlnkf_dT = (t.beta + t.Ta / Tb) / Tb
    aP = torch.zeros_like(kf)
    last = kf.dim() - 1

    if packed.has_plog:
        lnP = torch.log(pres)
        idx_lo, idx_hi = _plog_interval(t, lnP)
        lnk = (t.plog_logA + t.plog_beta * logT[..., None, None] -
               t.plog_Ta / T[..., None, None])
        dlnk = (t.plog_beta + t.plog_Ta / T[..., None, None]) / \
            T[..., None, None]
        lo, hi = _take_last(lnk, idx_lo), _take_last(lnk, idx_hi)
        dlo, dhi = _take_last(dlnk, idx_lo), _take_last(dlnk, idx_hi)
        P_lo = _take_last(t.plog_lnP, idx_lo)
        P_hi = _take_last(t.plog_lnP, idx_hi)
        denom = P_hi - P_lo
        safe = torch.where(denom == 0.0, 1.0, denom)
        w_raw = (lnP[..., None] - P_lo) / safe
        w = torch.clamp(w_raw, 0.0, 1.0)
        interior = (w_raw > 0.0) & (w_raw < 1.0) & (denom != 0.0)

        logkf_p = lo + (hi - lo) * w
        dlnkf_p = dlo + (dhi - dlo) * w
        aP_p = torch.where(interior, (hi - lo) / safe, 0.0)

        pidx = t.plog_idx
        kf = kf.index_copy(last, pidx, torch.exp(logkf_p))
        dlnkf_dT = dlnkf_dT.index_copy(last, pidx, dlnkf_p)
        aP = aP.index_copy(last, pidx, aP_p)

    if packed.has_cheb:
        tl, pl = t.cheb_tlim, t.cheb_plim
        Tred = ((2.0 / T)[..., None] - tl[:, 0]) / tl[:, 1]
        Pred = (2.0 * torch.log10(torch.clamp(pres, min=TINY))[..., None] -
                pl[:, 0]) / pl[:, 1]
        coef = t.cheb_coef
        NT, NP = coef.shape[1], coef.shape[2]
        Tp, dTp = _cheb_pows_with_derivs(Tred, NT)
        Pp, dPp = _cheb_pows_with_derivs(Pred, NP)
        log10k = torch.einsum('...ri,rij,...rj->...r', Tp, coef, Pp)
        dlog10k_dTred = torch.einsum('...ri,rij,...rj->...r', dTp, coef, Pp)
        dlog10k_dPred = torch.einsum('...ri,rij,...rj->...r', Tp, coef, dPp)
        dTred_dT = (-2.0 / (T * T))[..., None] / tl[:, 1]
        # Pred depends on log10 P: dPred/dlnP = 2 / (ln 10 * psub)
        dPred_dlnP = 2.0 / (LOG10 * pl[:, 1])

        cidx = t.cheb_idx
        kf = kf.index_copy(last, cidx, torch.exp(LOG10 * log10k))
        dlnkf_dT = dlnkf_dT.index_copy(
            last, cidx, LOG10 * dlog10k_dTred * dTred_dT)
        aP = aP.index_copy(last, cidx, LOG10 * dlog10k_dPred * dPred_dlnP)

    return kf, dlnkf_dT, aP


def _cheb_pows_with_derivs(x, n: int):
    """(T_0..T_{n-1}(x), T'_0..T'_{n-1}(x)) stacked on a trailing axis."""
    polys = [torch.ones_like(x)]
    derivs = [torch.zeros_like(x)]
    if n > 1:
        polys.append(x)
        derivs.append(torch.ones_like(x))
    for _ in range(2, n):
        derivs.append(2.0 * polys[-1] + 2.0 * x * derivs[-1] - derivs[-2])
        polys.append(2.0 * x * polys[-1] - polys[-2])
    return torch.stack(polys, dim=-1), torch.stack(derivs, dim=-1)


# ---------------------------------------------------------------------------
# concentration-power products with slot derivatives
# ---------------------------------------------------------------------------

def _pow_static(c, nu, max_int: int, has_frac: bool):
    """c ** nu with nu a constant tensor of small coefficients."""
    if has_frac:
        return torch.where(nu == 0.0, 1.0, torch.pow(c, nu))
    out = torch.where(nu == 0.0, 1.0, c)
    acc = c
    for k in range(2, max_int + 1):
        acc = acc * c
        out = torch.where(nu >= float(k), acc, out)
    return out


def _product_and_slot_derivs(packed, conc, sp_idx, nu):
    """(prod_s C^nu, d(prod)/dC_s per slot) — (..., R) and (..., R, S).

    Uses exclusive products over the (small, static) slot axis so zero
    concentrations never hit a division (the reference emits the
    product-without-C_j explicitly, create_jacobian.py:127-269).
    """
    cg = conc[..., sp_idx]                           # (..., R, S)
    powers = _pow_static(cg, nu, packed.max_nu_int, packed.has_frac_nu)
    total = torch.prod(powers, dim=-1)

    # exclusive products around each slot, multiplied in slot order as
    # the stage-A CUDA kernel does (S is a handful; torch's cumprod over
    # so short an innermost axis is also far slower on the card)
    S = powers.shape[-1]
    excl = []
    for s in range(S):
        e = torch.ones_like(powers[..., 0])
        for s2 in range(S):
            if s2 != s:
                e = e * powers[..., s2]
        excl.append(e)
    excl = torch.stack(excl, dim=-1)
    # d(C^nu)/dC = nu * C^(nu-1)
    if packed.has_frac_nu:
        # fractional nu - 1 may be negative: evaluate directly
        dpow = torch.where(nu == 0.0, 0.0, nu * torch.pow(cg, nu - 1.0))
    else:
        dpow = nu * _pow_static(cg, torch.clamp(nu - 1.0, min=0.0),
                                max(packed.max_nu_int - 1, 1), False)
        dpow = torch.where(nu == 0.0, 0.0, dpow)
    return total, dpow * excl


def _scatter_slots(vals, sp_idx, R: int, N: int):
    """Accumulate (..., R, S) slot values into a dense (..., R, N)
    matrix via static one-hot masks."""
    sp_idx = np.asarray(sp_idx)
    out = None
    rows = np.arange(R)
    for s in range(sp_idx.shape[1]):
        onehot = np.zeros((R, N), dtype=np.float64)
        onehot[rows, sp_idx[:, s]] = 1.0
        term = vals[..., s, None] * torch.as_tensor(onehot,
                                                    device=vals.device)
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# the per-reaction section
# ---------------------------------------------------------------------------

def reaction_parts(packed, param, y, conp: bool = True) -> dict:
    """Everything of the Jacobian up to the stoichiometric contraction.

    Returns a dict of state quantities (``T``, ``rho``, ``mw_avg``,
    ``y_full``, ``conc``, ``dlnrho_dT``, ``dlnP_dT``; shape (...,) or
    (..., N)) and per-reaction quantities (shape (..., R)): ``kf``,
    ``kr``, ``Rf``, ``Rr``, ``pm``, ``qnet``, ``q``, ``dq_dT``, ``c_u``,
    ``c_1``, ``psi``, ``xi``, plus the slot derivatives ``dpf`` /
    ``dpr`` (..., R, Sf/Sp) of the concentration products.
    """
    return reaction_parts_at(packed, state_quantities(packed, param, y, conp),
                             conp)


def state_quantities(packed, param, y, conp: bool = True) -> dict:
    """The per-state section of :func:`reaction_parts` (nothing
    per-reaction): ``T``, ``logT``, ``pres``, ``rho``, ``mw_avg``,
    ``y_full``, ``conc``, ``dlnrho_dT``, ``dlnP_dT`` and, for a
    reversible mechanism, ``smh`` and ``dsmh`` (..., N)."""
    inv_mw = to_device(packed, y.device).inv_mw
    T = y[..., 0]
    Y = y[..., 1:]
    logT = torch.log(T)
    y_N = 1.0 - torch.sum(Y, dim=-1)
    mw_avg = 1.0 / (torch.sum(Y * inv_mw[:-1], dim=-1) + y_N * inv_mw[-1])
    if conp:
        pres = torch.broadcast_to(as_f64(param, y.device), T.shape)
        rho = pres * mw_avg / (RU * T)
        dlnrho_dT = -1.0 / T
        dlnP_dT = torch.zeros_like(T)
    else:
        rho = torch.broadcast_to(as_f64(param, y.device), T.shape)
        pres = rho * RU * T / mw_avg
        dlnrho_dT = torch.zeros_like(T)
        dlnP_dT = 1.0 / T
    y_full = torch.cat([Y, y_N[..., None]], dim=-1)
    conc = rho[..., None] * y_full * inv_mw
    s = dict(T=T, logT=logT, pres=pres, rho=rho, mw_avg=mw_avg,
             y_full=y_full, conc=conc, dlnrho_dT=dlnrho_dT, dlnP_dT=dlnP_dT)
    if packed.has_rev:
        s.update(smh=eval_smh(packed, T), dsmh=eval_dsmh_dT(packed, T))
    return s


def reaction_parts_at(packed, s: dict, conp: bool = True) -> dict:
    """The per-reaction section of :func:`reaction_parts` on the state
    quantities ``s`` of :func:`state_quantities` (any tensors of those
    shapes, e.g. batch-major views of a batch-minor pre-stage)."""
    t = to_device(packed, s['T'].device)
    N = packed.n_species
    inv_mw = t.inv_mw
    T, logT, pres, rho = s['T'], s['logT'], s['pres'], s['rho']
    mw_avg, conc = s['mw_avg'], s['conc']
    dlnrho_dT, dlnP_dT = s['dlnrho_dT'], s['dlnP_dT']

    # --- forward/reverse rate constants and their log-derivatives ----------
    kf, dlnkf_dT, aP = _kf_with_derivs(packed, T, logT, pres)
    if packed.has_rev:
        lnKc = (torch.einsum('...n,rn->...r', s['smh'], t.nu_net) +
                t.sum_nu * (_LN_PA_RU - logT)[..., None])
        kr = torch.where(t.rev_mask, kf * torch.exp(-lnKc), 0.0)
        dlnKc_dT = (torch.einsum('...n,rn->...r', s['dsmh'], t.nu_net) -
                    t.sum_nu / T[..., None])
        dlnkr_dT = dlnkf_dT - dlnKc_dT
    else:
        kr = torch.zeros_like(kf)
        dlnkr_dT = torch.zeros_like(kf)

    # --- rates of progress and concentration (slot) derivatives ------------
    pf, dpf = _product_and_slot_derivs(packed, conc, t.reac_sp, t.reac_nu)
    pr_, dpr = _product_and_slot_derivs(packed, conc, t.prod_sp, t.prod_nu)
    Rf = kf * pf
    Rr = kr * pr_
    ordf = t.reac_nu.sum(dim=1)                                  # (R,)
    ordr = t.prod_nu.sum(dim=1)

    # --- pressure modification and its derivatives --------------------------
    pm = torch.ones_like(kf)
    dpm_dT = torch.zeros_like(kf)     # total d pm/dT (incl. conc(T) chain)
    # rank-one coefficient on u_vec, plus dense coefficients multiplying
    # the static alpha_tilde / pd_tilde matrices
    c_u_pm = torch.zeros_like(kf)
    psi = torch.zeros_like(kf)
    xi = torch.zeros_like(kf)

    if packed.has_pres_mod:
        m_tb = pres / (RU * T)
        thd = m_tb[..., None] + torch.einsum('...n,rn->...r', conc,
                                             t.eff_m1)

        if packed.has_thd_only:
            msk = t.thd_only_mask
            pm = torch.where(msk, thd, pm)
            if conp:
                dpm_dT = torch.where(msk, -thd / T[..., None], dpm_dT)
                c_u_pm = torch.where(
                    msk, -mw_avg[..., None] * (thd - m_tb[..., None]),
                    c_u_pm)
            else:
                c_u_pm = torch.where(msk, rho[..., None], c_u_pm)
            psi = torch.where(msk, rho[..., None], psi)

        if packed.has_falloff or packed.has_chemact:
            fall = t.falloff_mask
            chem = t.chemact_mask
            pdep = fall | chem
            Tb = T[..., None]
            kf_main = _arrhenius(t.logA, t.beta, t.Ta, T, logT)
            dln_main = (t.beta + t.Ta / Tb) / Tb
            k0 = torch.where(fall, _arrhenius(t.low_logA, t.low_beta,
                                              t.low_Ta, T, logT), kf_main)
            dlnk0_dT = torch.where(fall, (t.low_beta + t.low_Ta / Tb) / Tb,
                                   dln_main)
            kinf = torch.where(chem, _arrhenius(t.high_logA, t.high_beta,
                                                t.high_Ta, T, logT), kf_main)
            dlnkinf_dT = torch.where(
                chem, (t.high_beta + t.high_Ta / Tb) / Tb, dln_main)

            spec_mask = t.pdep_sp_idx >= 0
            if packed.has_specific_pdep_sp:
                X = torch.where(spec_mask,
                                conc[..., torch.clamp(t.pdep_sp_idx, min=0)],
                                thd)
            else:
                X = thd
            ratio = k0 / kinf
            Pr = ratio * X

            # --- blending factor F and derivatives --------------------------
            F = torch.ones_like(Pr)
            dF_dT = torch.zeros_like(Pr)    # explicit T dependence only
            dF_dL = torch.zeros_like(Pr)    # L = log10(max(Pr, tiny))
            L = torch.log10(torch.clamp(Pr, min=TINY))
            dL_dPr = torch.where(Pr > TINY,
                                 1.0 / (LOG10 * torch.clamp(Pr, min=TINY)),
                                 0.0)

            if packed.has_troe:
                tmask = t.troe_mask
                a = t.troe_par[:, 0]
                T3 = torch.where(tmask, t.troe_par[:, 1], 1.0)
                T1 = torch.where(tmask, t.troe_par[:, 2], 1.0)
                T2 = t.troe_par[:, 3]
                e3 = torch.exp(-Tb / T3)
                e1 = torch.exp(-Tb / T1)
                Fcent = (1.0 - a) * e3 + a * e1
                dFc_dT = -(1.0 - a) / T3 * e3 - a / T1 * e1
                if packed.troe_has_T2.any():
                    has2 = t.troe_has_T2
                    e2 = torch.exp(-T2 / Tb)
                    Fcent = Fcent + torch.where(has2, e2, 0.0)
                    dFc_dT = dFc_dT + torch.where(has2, T2 / (Tb * Tb) * e2,
                                                  0.0)
                c = torch.log10(torch.clamp(Fcent, min=TINY))
                dc_dT = torch.where(
                    Fcent > TINY,
                    dFc_dT / (LOG10 * torch.clamp(Fcent, min=TINY)), 0.0)
                A_ = L - 0.67 * c - 0.4
                B_ = 0.806 - 1.1762 * c - 0.14 * L
                AB = A_ / B_
                g = 1.0 / (1.0 + AB * AB)
                Ft = torch.exp(LOG10 * c * g)
                dg_dc = -g * g * 2.0 * AB * ((-0.67) * B_ -
                                             A_ * (-1.1762)) / (B_ * B_)
                dg_dL = -g * g * 2.0 * AB * (B_ - A_ * (-0.14)) / (B_ * B_)
                dFt_dT = Ft * LOG10 * (g + c * dg_dc) * dc_dT
                dFt_dL = Ft * LOG10 * c * dg_dL
                F = torch.where(tmask, Ft, F)
                dF_dT = torch.where(tmask, dFt_dT, dF_dT)
                dF_dL = torch.where(tmask, dFt_dL, dF_dL)

            if packed.has_sri:
                smask = t.sri_mask
                a_s = t.sri_par[:, 0]
                b_s = t.sri_par[:, 1]
                c_s = torch.where(smask, t.sri_par[:, 2], 1.0)
                d_s = t.sri_par[:, 3]
                e_s = t.sri_par[:, 4]
                eb = torch.exp(-b_s / Tb)
                ec = torch.exp(-Tb / c_s)
                base = torch.clamp(a_s * eb + ec, min=TINY)
                Xs = 1.0 / (1.0 + L * L)
                Fs = torch.pow(base, Xs) * d_s * torch.pow(Tb, e_s)
                dbase_dT = a_s * b_s / (Tb * Tb) * eb - ec / c_s
                dFs_dT = Fs * (Xs * dbase_dT / base + e_s / Tb)
                dXs_dL = -2.0 * L * Xs * Xs
                dFs_dL = Fs * torch.log(base) * dXs_dL
                F = torch.where(smask, Fs, F)
                dF_dT = torch.where(smask, dFs_dT, dF_dT)
                dF_dL = torch.where(smask, dFs_dL, dF_dL)

            G = torch.where(fall, Pr / (1.0 + Pr), 1.0 / (1.0 + Pr))
            dG_dPr = torch.where(fall, 1.0, -1.0) / ((1.0 + Pr) * (1.0 + Pr))
            # d pm/d Pr at fixed T-explicit parts
            Phi = F * dG_dPr + G * dF_dL * dL_dPr

            # --- temperature derivative ------------------------------------
            dlnX_dT = (-1.0 / Tb) if conp else 0.0
            dPr_dT = Pr * (dlnk0_dT - dlnkinf_dT + dlnX_dT)
            pm = torch.where(pdep, F * G, pm)
            dpm_dT = torch.where(pdep, G * dF_dT + Phi * dPr_dT, dpm_dT)

            # --- mass-fraction derivative ------------------------------------
            # dPr/dY_j = ratio * dX/dY_j
            if conp:
                cu_mix = -mw_avg[..., None] * (thd - m_tb[..., None])
            else:
                cu_mix = torch.broadcast_to(rho[..., None], thd.shape)
            if packed.has_specific_pdep_sp:
                cu_spec = (X * (-mw_avg[..., None]) if conp
                           else torch.zeros_like(X))
                cu_X = torch.where(spec_mask, cu_spec, cu_mix)
            else:
                cu_X = cu_mix
            c_u_pm = torch.where(pdep, Phi * ratio * cu_X, c_u_pm)
            psi = torch.where(pdep & ~spec_mask, Phi * ratio * rho[..., None],
                              psi)
            if packed.has_specific_pdep_sp:
                xi = torch.where(pdep & spec_mask,
                                 Phi * ratio * rho[..., None], xi)

    # --- assemble dq/dT and the rank-one coefficients (..., R) ---------------
    qnet = Rf - Rr
    q = pm * qnet
    dq_dT = (pm * (Rf * dlnkf_dT - Rr * dlnkr_dT) +
             pm * dlnrho_dT[..., None] * (ordf * Rf - ordr * Rr) +
             dpm_dT * qnet +
             pm * qnet * aP * dlnP_dT[..., None])
    c_u = (pm * (ordf * Rf - ordr * Rr) * (-mw_avg[..., None]) if conp
           else torch.zeros_like(q))
    c_u = c_u + c_u_pm * qnet
    if not conp:
        # P-dependence of kf under CONV: dln P/dY_j = mw_avg u_j
        c_u = c_u + pm * qnet * aP * mw_avg[..., None]
    # D[..., r, N-1]: the slots that hit the eliminated species
    kdf = kf[..., None] * dpf
    kdr = kr[..., None] * dpr
    D_last = (torch.sum(torch.where(t.reac_sp == N - 1, kdf, 0.0), dim=-1) -
              torch.sum(torch.where(t.prod_sp == N - 1, kdr, 0.0), dim=-1))
    c_1 = -pm * rho[..., None] * inv_mw[-1] * D_last

    return dict(s, kf=kf, kr=kr, dpf=dpf, dpr=dpr, Rf=Rf, Rr=Rr, pm=pm,
                qnet=qnet, q=q, dq_dT=dq_dT, c_u=c_u, c_1=c_1, psi=psi,
                xi=xi)


def heat_terms(packed, T, conp: bool):
    """(cp or cv, h or u, dcp/dT) per species, (..., N) each."""
    if conp:
        return eval_cp(packed, T), eval_h(packed, T), eval_dcp_dT(packed, T)
    return eval_cv(packed, T), eval_u(packed, T), eval_dcp_dT(packed, T)


# ---------------------------------------------------------------------------
# the Jacobian
# ---------------------------------------------------------------------------

def eval_jacobian(packed, t, param, y, conp: bool = True,
                  return_dydt: bool = False):
    """Analytical Jacobian J[..., i, j] = d f_i / d y_j, shape (..., N, N).

    ``param`` is pressure [Pa] (conp=True) or density [kg/m^3]
    (conp=False); ``y = [T, Y_1..Y_{N-1}]`` float64.  With
    ``return_dydt`` the state derivative (computed anyway) is returned
    alongside.
    """
    tb = to_device(packed, y.device)
    N = packed.n_species
    R = packed.n_reactions
    p = reaction_parts(packed, param, y, conp=conp)
    T, rho, mw_avg, y_full = p['T'], p['rho'], p['mw_avg'], p['y_full']
    dlnrho_dT = p['dlnrho_dT']
    inv_mw, mw, nu_net = tb.inv_mw, tb.mw, tb.nu_net
    u_vec = inv_mw[:-1] - inv_mw[-1]                            # (N-1,)
    if conp:
        r_vec = -mw_avg[..., None] * u_vec                     # dln rho/dY_j
    else:
        r_vec = torch.zeros(T.shape + (N - 1,), dtype=y.dtype,
                            device=y.device)

    # D[b, r, m] = d(Rf - Rr)/dC_m
    D = (_scatter_slots(p['kf'][..., None] * p['dpf'], packed.reac_sp, R, N) -
         _scatter_slots(p['kr'][..., None] * p['dpr'], packed.prod_sp, R, N))

    # --- assemble dq/dY via contraction + rank-one structure ----------------
    P1 = p['pm'][..., None] * rho[..., None, None] * D[..., :-1] * inv_mw[:-1]
    if packed.has_pres_mod:
        alpha_tilde = (packed.eff_m1[:, :-1] * packed.inv_mw[None, :-1] -
                       (packed.eff_m1[:, -1] * packed.inv_mw[-1])[:, None])
        P1 = P1 + (p['psi'] * p['qnet'])[..., None] * torch.as_tensor(
            alpha_tilde, device=y.device)
        if packed.has_specific_pdep_sp:
            pd = np.asarray(packed.pdep_sp_idx)
            pd_tilde = np.zeros((R, N - 1))
            for rr in np.where(pd >= 0)[0]:
                if pd[rr] < N - 1:
                    pd_tilde[rr, pd[rr]] += packed.inv_mw[pd[rr]]
                else:
                    pd_tilde[rr, :] -= packed.inv_mw[N - 1]
            P1 = P1 + (p['xi'] * p['qnet'])[..., None] * torch.as_tensor(
                pd_tilde, device=y.device)

    # --- contract with stoichiometry -----------------------------------------
    domega_dT = torch.einsum('...r,rn->...n', p['dq_dT'], nu_net)  # (..., N)
    domega_dY = torch.einsum('...rj,rn->...nj', P1, nu_net)   # (..., N, N-1)
    v_u = torch.einsum('...r,rn->...n', p['c_u'], nu_net)
    v_1 = torch.einsum('...r,rn->...n', p['c_1'], nu_net)
    domega_dY = domega_dY + v_u[..., None] * u_vec + v_1[..., None]
    omega = torch.einsum('...r,rn->...n', p['q'], nu_net)

    # --- thermodynamic closures ---------------------------------------------------
    de_dT, e_spec, dcp = heat_terms(packed, T, conp)
    spec_heat_avg = torch.sum(de_dT * y_full, dim=-1)
    dsh_dT = torch.sum(dcp * y_full, dim=-1)

    rho_inv = 1.0 / rho
    fk = omega * mw * rho_inv[..., None]              # (..., N) incl. last
    denomT = rho * spec_heat_avg
    eWn = e_spec * mw / denomT[..., None]
    fT = -torch.sum(eWn * omega, dim=-1)

    # species rows (reduced)
    JYY = mw[:-1, None] * rho_inv[..., None, None] * domega_dY[..., :-1, :]
    if conp:
        JYY = JYY - fk[..., :-1, None] * r_vec[..., None, :]
    JYT = (mw[:-1] * rho_inv[..., None] * domega_dT[..., :-1] -
           fk[..., :-1] * dlnrho_dT[..., None])

    # temperature row
    JTY = -torch.einsum('...n,...nj->...j', eWn, domega_dY)
    heat_j = de_dT[..., :-1] - de_dT[..., -1:]
    JTY = JTY - fT[..., None] * (r_vec + heat_j / spec_heat_avg[..., None])
    JTT = (-(torch.sum(de_dT * mw * omega / denomT[..., None], dim=-1) +
             torch.sum(eWn * domega_dT, dim=-1)) -
           fT * (dlnrho_dT + dsh_dT / spec_heat_avg))

    # --- stitch (..., N, N) -----------------------------------------------------
    top = torch.cat([JTT[..., None, None], JTY[..., None, :]], dim=-1)
    bottom = torch.cat([JYT[..., :, None], JYY], dim=-1)
    J = torch.cat([top, bottom], dim=-2)
    if return_dydt:
        f_state = torch.cat([fT[..., None], fk[..., :-1]], dim=-1)
        return J, f_state
    return J


def jacobian_and_dydt(packed, t, param, y, conp: bool = True):
    """(J, dy/dt) in one fused evaluation — dy/dt falls out of the
    Jacobian assembly for free (the reference's eval_jacob likewise
    computes the rates internally, create_jacobian.py:2274-3277)."""
    return eval_jacobian(packed, t, param, y, conp=conp, return_dydt=True)


# ---------------------------------------------------------------------------
# forward-mode AD oracle (the Adept-autodiff analog)
# ---------------------------------------------------------------------------

def jacobian_fwd(packed, t, param, y, conp: bool = True):
    """Jacobian via ``torch.func.jacfwd`` of dydt — exact, used as the
    correctness oracle for :func:`eval_jacobian` (the reference
    validates its emitted Jacobian against Adept autodiff the same way,
    functional_tester/test.py:173-217)."""
    def single(yy, pp):
        return dydt_dispatch(packed, t, pp, yy, conp=conp)

    jac = torch.func.jacfwd(single)
    if y.dim() == 1:
        return jac(y, as_f64(param, y.device))
    param_b = torch.broadcast_to(as_f64(param, y.device), y.shape[:-1])
    flat_y = y.reshape(-1, y.shape[-1])
    flat_p = param_b.reshape(-1)
    out = torch.func.vmap(jac)(flat_y, flat_p)
    return out.reshape(y.shape[:-1] + out.shape[-2:])


def jacobian_vector_product(packed, t, param, y, v, conp: bool = True):
    """J @ v without forming J — the reference's ``sparse_multiplier``
    analog (create_jacobian.py:3301-3404), exact via ``torch.func.jvp``."""
    def single(yy):
        return dydt_dispatch(packed, t, param, yy, conp=conp)
    _, jv = torch.func.jvp(single, (y,), (v,))
    return jv
