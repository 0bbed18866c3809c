"""Independent NumPy reference implementation for validation.

A deliberately naive, loop-based, IR-driven evaluator of concentrations,
rate constants, equilibrium constants, pressure modifications, species
rates, and dy/dt — written directly from the Chemkin formulas, *not*
from the packed tensors — so it exercises a completely different code
path than the JAX kernels.  It plays the role the Cantera / TChem
oracles play in the reference's functional tester
(reference: pyjac/functional_tester/test.py:279-1028).

Everything here is scalar per state; use only on small batches.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ..core.constants import PA, RU
from ..core.ir import Reaction, Species
from ..core.mech import Mechanism


def _nasa(sp: Species, T: float) -> np.ndarray:
    return sp.lo if T <= sp.Trange[1] else sp.hi


def cp_mass(sp: Species, T: float) -> float:
    a = _nasa(sp, T)
    cp_R = a[0] + a[1] * T + a[2] * T**2 + a[3] * T**3 + a[4] * T**4
    return RU / sp.mw * cp_R


def cv_mass(sp: Species, T: float) -> float:
    return cp_mass(sp, T) - RU / sp.mw


def h_mass(sp: Species, T: float) -> float:
    a = _nasa(sp, T)
    h_RT = (a[0] + a[1] * T / 2 + a[2] * T**2 / 3 + a[3] * T**3 / 4 +
            a[4] * T**4 / 5 + a[5] / T)
    return RU / sp.mw * T * h_RT


def u_mass(sp: Species, T: float) -> float:
    return h_mass(sp, T) - RU / sp.mw * T


def smh(sp: Species, T: float) -> float:
    a = _nasa(sp, T)
    return (a[0] * (math.log(T) - 1.0) + a[1] * T / 2 + a[2] * T**2 / 6 +
            a[3] * T**3 / 12 + a[4] * T**4 / 20 - a[5] / T + a[6])


def arrhenius(A: float, b: float, Ta: float, T: float) -> float:
    return A * T**b * math.exp(-Ta / T)


def concentrations(mech: Mechanism, T: float, P: float, Y: np.ndarray):
    """Y is the reduced (N-1) mass-fraction vector."""
    y_N = 1.0 - Y.sum()
    yfull = np.concatenate([Y, [y_N]])
    mws = np.array([sp.mw for sp in mech.specs])
    mw_avg = 1.0 / (yfull / mws).sum()
    rho = P * mw_avg / (RU * T)
    conc = rho * yfull / mws
    return y_N, mw_avg, rho, conc


def forward_rate_constant(rxn: Reaction, T: float, P: float) -> float:
    if rxn.plog:
        pars = sorted(rxn.plog_par, key=lambda p: p[0])
        if P <= pars[0][0]:
            _, A, b, E = pars[0]
            return arrhenius(A, b, E, T)
        if P > pars[-1][0]:
            _, A, b, E = pars[-1]
            return arrhenius(A, b, E, T)
        for (P1, A1, b1, E1), (P2, A2, b2, E2) in zip(pars, pars[1:]):
            if P1 < P <= P2:
                lk1 = math.log(arrhenius(A1, b1, E1, T))
                lk2 = math.log(arrhenius(A2, b2, E2, T))
                w = (math.log(P) - math.log(P1)) / (math.log(P2) -
                                                    math.log(P1))
                return math.exp(lk1 + (lk2 - lk1) * w)
        raise AssertionError('unreachable')
    if rxn.cheb:
        t0, t1 = rxn.cheb_tlim
        p0, p1 = rxn.cheb_plim
        Tred = ((2.0 / T) - (1 / t0 + 1 / t1)) / (1 / t1 - 1 / t0)
        Pred = ((2.0 * math.log10(P) - math.log10(p0) - math.log10(p1)) /
                (math.log10(p1) - math.log10(p0)))
        nt, npp = rxn.cheb_n_temp, rxn.cheb_n_pres
        Tch = np.polynomial.chebyshev.chebvander(Tred, nt - 1)[0]
        Pch = np.polynomial.chebyshev.chebvander(Pred, npp - 1)[0]
        logk = float(Tch @ np.asarray(rxn.cheb_par) @ Pch)
        return 10.0 ** logk
    return arrhenius(rxn.A, rxn.b, rxn.E, T)


def equilibrium_constant(mech: Mechanism, rxn: Reaction, T: float) -> float:
    dnu = 0.0
    expo = 0.0
    for sp, nu in zip(rxn.prod, rxn.prod_nu):
        expo += nu * smh(mech.specs[sp], T)
        dnu += nu
    for sp, nu in zip(rxn.reac, rxn.reac_nu):
        expo -= nu * smh(mech.specs[sp], T)
        dnu -= nu
    return (PA / (RU * T)) ** dnu * math.exp(expo)


def pres_mod_factor(mech: Mechanism, rxn: Reaction, T: float, P: float,
                    conc: np.ndarray) -> float:
    """Pressure-modification factor; 1.0 for plain reactions."""
    if not (rxn.thd_body or rxn.pdep):
        return 1.0
    m = P / (RU * T)
    thd = m + sum((eff - 1.0) * conc[sp] for sp, eff in rxn.thd_body_eff)
    if rxn.thd_body:
        return thd

    kf_main = arrhenius(rxn.A, rxn.b, rxn.E, T)
    k0 = arrhenius(*rxn.low, T=T) if rxn.low else kf_main
    kinf = arrhenius(*rxn.high, T=T) if rxn.high else kf_main
    X = conc[rxn.pdep_sp] if rxn.pdep_sp is not None else thd
    Pr = k0 * X / kinf

    if rxn.troe:
        a, T3, T1 = rxn.troe_par[:3]
        Fcent = (1 - a) * math.exp(-T / T3) + a * math.exp(-T / T1)
        if len(rxn.troe_par) == 4 and rxn.troe_par[3] != 0.0:
            Fcent += math.exp(-rxn.troe_par[3] / T)
        logFc = math.log10(max(Fcent, 1e-300))
        logPr = math.log10(max(Pr, 1e-300))
        A_ = logPr - 0.67 * logFc - 0.4
        B_ = 0.806 - 1.1762 * logFc - 0.14 * logPr
        F = 10.0 ** (logFc / (1.0 + (A_ / B_) ** 2))
    elif rxn.sri:
        a, b, c = rxn.sri_par[:3]
        d, e = (rxn.sri_par[3], rxn.sri_par[4]) if len(rxn.sri_par) == 5 \
            else (1.0, 0.0)
        logPr = math.log10(max(Pr, 1e-300))
        X_ = 1.0 / (1.0 + logPr ** 2)
        F = (a * math.exp(-b / T) + math.exp(-T / c)) ** X_ * d * T ** e
    else:
        F = 1.0

    if rxn.low:
        return F * Pr / (1.0 + Pr)
    return F / (1.0 + Pr)


def evaluate(mech: Mechanism, T: float, P: float,
             Y: np.ndarray) -> Dict[str, np.ndarray]:
    """Full per-state evaluation: all intermediates plus dy/dt (CONP)."""
    N = mech.n_species
    R = mech.n_reactions
    y_N, mw_avg, rho, conc = concentrations(mech, T, P, Y)

    kf = np.zeros(R)
    kc = np.zeros(R)
    fwd = np.zeros(R)
    rev = np.zeros(R)
    pm = np.zeros(R)
    for i, rxn in enumerate(mech.reacs):
        kf[i] = forward_rate_constant(rxn, T, P)
        prodf = 1.0
        for sp, nu in zip(rxn.reac, rxn.reac_nu):
            prodf *= conc[sp] ** nu
        fwd[i] = kf[i] * prodf
        if rxn.rev:
            kc[i] = equilibrium_constant(mech, rxn, T)
            prodr = 1.0
            for sp, nu in zip(rxn.prod, rxn.prod_nu):
                prodr *= conc[sp] ** nu
            rev[i] = kf[i] / kc[i] * prodr
        pm[i] = pres_mod_factor(mech, rxn, T, P, conc)

    wdot = np.zeros(N)
    for i, rxn in enumerate(mech.reacs):
        q = pm[i] * (fwd[i] - rev[i])
        for sp, nu in zip(rxn.reac, rxn.reac_nu):
            wdot[sp] -= nu * q
        for sp, nu in zip(rxn.prod, rxn.prod_nu):
            wdot[sp] += nu * q

    mws = np.array([sp.mw for sp in mech.specs])
    cp = np.array([cp_mass(sp, T) for sp in mech.specs])
    h = np.array([h_mass(sp, T) for sp in mech.specs])
    yfull = np.concatenate([Y, [y_N]])
    cp_avg = float(cp @ yfull)
    dT = -float(h * mws @ wdot) / (rho * cp_avg)
    dY = wdot[:-1] * mws[:-1] / rho
    dydt = np.concatenate([[dT], dY])

    return {'y_N': y_N, 'mw_avg': mw_avg, 'rho': rho, 'conc': conc,
            'kf': kf, 'kc': kc, 'fwd': fwd, 'rev': rev, 'pres_mod': pm,
            'wdot': wdot, 'dydt': dydt, 'cp': cp, 'h': h}


def evaluate_conv(mech: Mechanism, T: float, rho: float,
                  Y: np.ndarray) -> Dict[str, np.ndarray]:
    """Constant-volume dy/dt (pressure derived from density)."""
    y_N = 1.0 - Y.sum()
    yfull = np.concatenate([Y, [y_N]])
    mws = np.array([sp.mw for sp in mech.specs])
    mw_avg = 1.0 / (yfull / mws).sum()
    P = rho * RU * T / mw_avg
    out = evaluate(mech, T, P, Y)
    cv = np.array([cv_mass(sp, T) for sp in mech.specs])
    u = np.array([u_mass(sp, T) for sp in mech.specs])
    cv_avg = float(cv @ yfull)
    dT = -float(u * mws @ out['wdot']) / (rho * cv_avg)
    dY = out['wdot'][:-1] * mws[:-1] / rho
    out['dydt'] = np.concatenate([[dT], dY])
    out['pres'] = P
    return out
