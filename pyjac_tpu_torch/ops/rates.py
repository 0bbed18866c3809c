"""Reaction-rate kernels: forward/reverse rates of progress and pressure
modifications, batched over states.

PyTorch counterpart of ``pyjac_tpu/ops/rates.py`` (reference:
pyjac/core/rate_subs.py:254-877 ``write_rxn_rates``, :879-1290
``write_rxn_pressure_mod``).  Every reaction category is covered:
Arrhenius (negative A included), PLOG, Chebyshev, reversible via Kc,
third-body, Lindemann / Troe / SRI falloff, chemically activated,
species-specific pdep and fractional stoichiometry.  The log-space
variants of the JAX module (an f32-range workaround for the TPU) are
not ported.

All arrays are (batch..., R) float64 with R the full reaction count;
reverse rates are zero on irreversible rows and ``pres_mod`` is one on
rows without third-body/falloff behaviour, so the downstream
species-rate and Jacobian assembly stays a dense contraction.
"""

from __future__ import annotations

import math

import torch

from ..core.constants import PA, RU
from .common import LOG10, safe_log10, to_device
from .thermo import eval_smh

_LN_PA_RU = math.log(PA / RU)


# --------------------------------------------------------------------------
# forward rate constants
# --------------------------------------------------------------------------

def _arrhenius(logA, beta, Ta, T, logT):
    """exp(log A + beta log T - Ta / T) — the reference's folded form
    (reference: rate_subs.py:27-146 ``rxn_rate_const``).

    Parameter tensors are (R,); T/logT carry batch dims and gain a
    trailing reaction axis here.
    """
    return torch.exp(logA + beta * logT[..., None] - Ta / T[..., None])


def _plog_interval(t, lnP):
    """Lower/upper PLOG breakpoint indices for each PLOG row, (..., Rp)."""
    cnt = torch.sum(lnP[..., None, None] > t.plog_lnP, dim=-1)
    idx_lo = torch.minimum(torch.clamp(cnt - 1, min=0),
                           torch.clamp(t.plog_n - 2, min=0))
    idx_hi = torch.minimum(idx_lo + 1, t.plog_n - 1)
    return idx_lo, idx_hi


def _take_last(arr, idx):
    """arr[..., r, idx[..., r]] with ``arr`` broadcast to idx's batch."""
    full = arr.expand(idx.shape + arr.shape[-1:])
    return torch.gather(full, -1, idx[..., None])[..., 0]


def _plog_logkf(packed, T, logT, pres):
    """log kf for PLOG rows: piecewise log-linear interpolation in ln P
    (reference: rate_subs.py:598-632). Returns (..., Rp)."""
    t = to_device(packed, T.device)
    lnP = torch.log(pres)
    idx_lo, idx_hi = _plog_interval(t, lnP)
    lnk = (t.plog_logA + t.plog_beta * logT[..., None, None]
           - t.plog_Ta / T[..., None, None])               # (..., Rp, P)
    lo = _take_last(lnk, idx_lo)
    hi = _take_last(lnk, idx_hi)
    P_lo = _take_last(t.plog_lnP, idx_lo)
    P_hi = _take_last(t.plog_lnP, idx_hi)
    denom = P_hi - P_lo
    w = (lnP[..., None] - P_lo) / torch.where(denom == 0.0, 1.0, denom)
    # clamping w to [0, 1] reproduces the constant extrapolation outside
    # the tabulated pressure range
    w = torch.clamp(w, 0.0, 1.0)
    return lo + (hi - lo) * w


def _cheb_pows(x, n: int):
    """First-kind Chebyshev polynomials T_0..T_{n-1}(x), stacked on a new
    trailing axis (static recurrence, reference: rate_subs.py:196-247)."""
    polys = [torch.ones_like(x)]
    if n > 1:
        polys.append(x)
    for _ in range(2, n):
        polys.append(2.0 * x * polys[-1] - polys[-2])
    return torch.stack(polys, dim=-1)


def _cheb_log10kf(packed, T, pres):
    """log10 kf for Chebyshev rows (reference: rate_subs.py:149-251).
    Returns (..., Rc)."""
    t = to_device(packed, T.device)
    tl, pl = t.cheb_tlim, t.cheb_plim
    Tred = ((2.0 / T)[..., None] - tl[:, 0]) / tl[:, 1]
    Pred = (2.0 * safe_log10(pres)[..., None] - pl[:, 0]) / pl[:, 1]
    coef = t.cheb_coef                                   # (Rc, NT, NP)
    Tp = _cheb_pows(Tred, coef.shape[1])                 # (..., Rc, NT)
    Pp = _cheb_pows(Pred, coef.shape[2])                 # (..., Rc, NP)
    return torch.einsum('...ri,rij,...rj->...r', Tp, coef, Pp)


def eval_kf(packed, T, pres):
    """Forward rate constants for all reactions, (..., R).

    For falloff (LOW) rows this is the high-pressure limit and for
    chemically-activated (HIGH) rows the low-pressure limit, exactly as
    in the reference where ``pres_mod`` supplies the blending.
    """
    t = to_device(packed, T.device)
    logT = torch.log(T)
    kf = _arrhenius(t.logA, t.beta, t.Ta, T, logT)
    if packed.has_negative_A:
        kf = kf * t.A_sign
    if packed.has_plog:
        kf_p = torch.exp(_plog_logkf(packed, T, logT, pres))
        kf = kf.index_copy(kf.dim() - 1, t.plog_idx, kf_p)
    if packed.has_cheb:
        kf_c = torch.exp(LOG10 * _cheb_log10kf(packed, T, pres))
        kf = kf.index_copy(kf.dim() - 1, t.cheb_idx, kf_c)
    return kf


def eval_kc(packed, T):
    """Equilibrium constants in concentration units for all reactions.

    Kc = (PA / (RU T))^sum_nu * exp(sum_k nu_net[k] * smh_k)
    (reference: rate_subs.py:660-809; coefficient grouping done at pack
    time instead of in emitted text).
    """
    t = to_device(packed, T.device)
    logT = torch.log(T)
    smh = eval_smh(packed, T)                                   # (..., N)
    expo = torch.einsum('...n,rn->...r', smh, t.nu_net)
    expo = expo + t.sum_nu * (_LN_PA_RU - logT)[..., None]
    return torch.exp(expo)


# --------------------------------------------------------------------------
# concentration powers
# --------------------------------------------------------------------------

def _conc_power_product(packed, conc, sp_idx, nu):
    """prod_s C[sp]^nu over padded stoichiometric slots, (..., R)."""
    cg = conc[..., sp_idx]                        # (..., R, S) static gather
    if packed.has_frac_nu:
        term = torch.where(nu == 0.0, 1.0, torch.pow(cg, nu))
    else:
        # unrolled integer powers (reference: rate_subs.py:641-648)
        term = torch.where(nu == 0.0, 1.0, cg)
        acc = cg
        for k in range(2, packed.max_nu_int + 1):
            acc = acc * cg
            term = torch.where(nu >= float(k), acc, term)
    return torch.prod(term, dim=-1)


def eval_rxn_rates(packed, T, pres, conc):
    """Forward and reverse rates of progress, each (..., R) [kmol/m^3/s].

    Reverse entries are zero for irreversible reactions (the reference
    compacts them; :func:`compact_rev` recovers that layout).
    Reference: rate_subs.py:254-877.
    """
    t = to_device(packed, conc.device)
    kf = eval_kf(packed, T, pres)
    fwd = kf * _conc_power_product(packed, conc, t.reac_sp, t.reac_nu)
    if packed.has_rev:
        kc = eval_kc(packed, T)
        kr = kf / kc
        rev = kr * _conc_power_product(packed, conc, t.prod_sp, t.prod_nu)
        rev = torch.where(t.rev_mask, rev, 0.0)
    else:
        rev = torch.zeros_like(fwd)
    return fwd, rev


# --------------------------------------------------------------------------
# pressure modification
# --------------------------------------------------------------------------

def third_body_concentrations(packed, T, pres, conc):
    """Effective third-body concentration m + sum (alpha-1) C per reaction,
    (..., R) (reference: rate_subs.py:1120-1148)."""
    m = pres / (RU * T)
    return m[..., None] + torch.einsum(
        '...n,rn->...r', conc, to_device(packed, conc.device).eff_m1)


def _troe_F(packed, T, Pr):
    """Troe falloff blending factor (reference: rate_subs.py:1187-1227)."""
    t = to_device(packed, T.device)
    mask = t.troe_mask
    a = t.troe_par[:, 0]
    # sanitise dead lanes so no inf/NaN leaks into AD tangents
    T3 = torch.where(mask, t.troe_par[:, 1], 1.0)
    T1 = torch.where(mask, t.troe_par[:, 2], 1.0)
    T2 = t.troe_par[:, 3]
    Tb = T[..., None]
    Fcent = (1.0 - a) * torch.exp(-Tb / T3) + a * torch.exp(-Tb / T1)
    if packed.troe_has_T2.any():
        Fcent = Fcent + torch.where(t.troe_has_T2, torch.exp(-T2 / Tb), 0.0)
    logFc = safe_log10(Fcent)
    logPr = safe_log10(Pr)
    A = logPr - 0.67 * logFc - 0.4
    B = 0.806 - 1.1762 * logFc - 0.14 * logPr
    return torch.exp(LOG10 * (logFc / (1.0 + (A / B) ** 2)))


def _sri_F(packed, T, Pr):
    """SRI falloff blending factor (reference: rate_subs.py:1229-1256)."""
    t = to_device(packed, T.device)
    a = t.sri_par[:, 0]
    b = t.sri_par[:, 1]
    c = torch.where(t.sri_mask, t.sri_par[:, 2], 1.0)
    d = t.sri_par[:, 3]
    e = t.sri_par[:, 4]
    Tb = T[..., None]
    logPr = safe_log10(Pr)
    X = 1.0 / (1.0 + logPr * logPr)
    base = a * torch.exp(-b / Tb) + torch.exp(-Tb / c)
    F = torch.pow(torch.clamp(base, min=0.0), X)
    return F * d * torch.pow(Tb, e)


def get_rxn_pres_mod(packed, T, pres, conc):
    """Pressure-modification factors for all reactions, (..., R).

    Rows without third-body/falloff behaviour get exactly 1.0, so
    ``pm * (fwd - rev)`` is the universal rate of progress.
    Reference: rate_subs.py:879-1290.
    """
    t = to_device(packed, conc.device)
    R = packed.n_reactions
    ones = torch.ones(conc.shape[:-1] + (R,), dtype=conc.dtype,
                      device=conc.device)
    if not packed.has_pres_mod:
        return ones

    logT = torch.log(T)
    thd = third_body_concentrations(packed, T, pres, conc)
    pm = ones

    if packed.has_thd_only:
        pm = torch.where(t.thd_only_mask, thd, pm)

    if packed.has_falloff or packed.has_chemact:
        fall = t.falloff_mask
        chem = t.chemact_mask
        pdep = fall | chem
        kf_main = _arrhenius(t.logA, t.beta, t.Ta, T, logT)
        k0 = torch.where(
            fall, _arrhenius(t.low_logA, t.low_beta, t.low_Ta, T, logT),
            kf_main)
        kinf = torch.where(
            chem, _arrhenius(t.high_logA, t.high_beta, t.high_Ta, T, logT),
            kf_main)
        if packed.has_specific_pdep_sp:
            sp_idx = torch.clamp(t.pdep_sp_idx, min=0)
            c_sp = conc[..., sp_idx]
            X = torch.where(t.pdep_sp_idx >= 0, c_sp, thd)
        else:
            X = thd
        Pr = k0 * X / kinf

        F = torch.ones_like(Pr)
        if packed.has_troe:
            F = torch.where(t.troe_mask, _troe_F(packed, T, Pr), F)
        if packed.has_sri:
            F = torch.where(t.sri_mask, _sri_F(packed, T, Pr), F)

        blend = torch.where(fall, Pr / (1.0 + Pr), 1.0 / (1.0 + Pr))
        pm = torch.where(pdep, F * blend, pm)

    return pm


# --------------------------------------------------------------------------
# species production rates
# --------------------------------------------------------------------------

def eval_spec_rates(packed, fwd, rev, pres_mod):
    """Net molar production rate per species, (..., N) [kmol/m^3/s].

    omega = nu_net^T (pres_mod * (fwd - rev)) as a dense batched
    contraction (reference: rate_subs.py:1297-1527 emits this as signed
    scalar sums).
    """
    q = pres_mod * (fwd - rev)
    return torch.einsum('...r,rn->...n', q,
                        to_device(packed, q.device).nu_net)


def rates_of_progress(packed, T, pres, conc):
    """Convenience: (fwd, rev, pres_mod, net q) in one call."""
    fwd, rev = eval_rxn_rates(packed, T, pres, conc)
    pm = get_rxn_pres_mod(packed, T, pres, conc)
    return fwd, rev, pm, pm * (fwd - rev)


# --------------------------------------------------------------------------
# layout helpers for reference parity
# --------------------------------------------------------------------------

def compact_rev(packed, rev):
    """Gather reverse rates into the reference's compacted layout
    (only reversible reactions, reference: rate_subs.py:811-813)."""
    return rev[..., to_device(packed, rev.device).rev_map]


def compact_pres_mod(packed, pres_mod):
    """Gather pres_mod into the reference's compacted layout
    (only third-body/falloff reactions)."""
    return pres_mod[..., to_device(packed, pres_mod.device).pres_mod_map]
