"""Float32 fused Jacobian + dy/dt (``F32Jacobian``).

PyTorch port of ``pyjac_tpu.ops.pallas_jacobian.PallasJacobian``
(``pallas_jacobian.py:775-865``), the pure-throughput f32 configuration.
On the card one hand-written CUDA kernel, K3 (the float instantiation of
``csrc/dense_fused.cu``; TPU kernel ``_kernel``), computes the whole
float32 Jacobian and dy/dt of a batch of states in one launch.  Its
plain PyTorch version, :func:`f32_reference`, is a float32 transcription
of the TPU kernel's math (``_compute``, then ``_kernel``'s column loop).

Differences from the TPU kernel, all consequences of the card: the
one-hot gather / scatter matmuls and the bf16 three-way ``_dot_x`` /
``_dot_ex`` splits exist only for the MXU, so the plain version uses
indexed loads and plain float32 products (never TF32); no batch tiles
(``block_b``: the kernel masks the ragged batch edge); no ``interpret``
(the plain version plays that part); and no 50 MB VMEM constant limit
in :func:`supports`.  The float32 range guards are the TPU kernel's:
``TINY32`` = 1e-30 where the float64 path floors at 1e-300.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.constants import RU
from ..profiling import span
from . import kernels
from .common import LOG10, cached, entry_device
from .jacobian_big import parts_tables
# K3 covers what K4 covers (``pallas_jacobian.supports``: sign-flipping
# PLOG tables are refused; its 50 MB VMEM clause is a TPU limit)
from .jacobian_dense import DenseJacobian, fused_tables, supports
from .rates import _LN_PA_RU

F32 = torch.float32
# the float32 range guard (pallas_jacobian._TINY32; 1e-300 in f64)
TINY32 = 1.0e-30


def check_state_width(y, n_state: int, cls: str) -> None:
    """Validate the (B, N) state batch width up front
    (``pallas_jacobian.check_state_width``): a batch drawn for another
    variant of the mechanism otherwise fails deep inside the kernel's
    launcher."""
    shape = getattr(y, 'shape', None)
    if shape is None or len(shape) != 2 or shape[1] != n_state:
        raise ValueError(
            '%s: state batch must be (B, %d) = [T, Y_1..Y_%d] for this '
            'mechanism (got %s); check that the states were drawn for '
            'the SAME mechanism file the kernel was packed from'
            % (cls, n_state, n_state - 1, (tuple(shape) if shape is not None
                                          else None,)))


def _consts(packed, device):
    """The plain version's constants (``pallas_jacobian._consts`` without
    the one-hot matrices): float32 tensors, int64 index tensors and the
    static ``meta`` switches; per-reaction columns are (R, 1)."""
    N, R = packed.n_species, packed.n_reactions
    J = N - 1
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    col = lambda a: f(np.asarray(a, np.float64)[:, None])
    idx = lambda a: torch.as_tensor(np.asarray(a).astype(np.int64),
                                    device=device)
    inv_mw = np.asarray(packed.inv_mw, np.float64)
    reac_nu = np.asarray(packed.reac_nu, np.float64)
    prod_nu = np.asarray(packed.prod_nu, np.float64)
    eff_m1 = np.asarray(packed.eff_m1, np.float64)
    alpha_tilde = (eff_m1[:, :-1] * inv_mw[None, :-1] -
                   (eff_m1[:, -1] * inv_mw[-1])[:, None])
    pd = np.asarray(packed.pdep_sp_idx)
    pd_tilde = np.zeros((R, J))
    for r in np.where(pd >= 0)[0]:
        if pd[r] < J:
            pd_tilde[r, pd[r]] += inv_mw[pd[r]]
        else:
            pd_tilde[r, :] -= inv_mw[-1]
    troe, sri = np.asarray(packed.troe_mask), np.asarray(packed.sri_mask)
    c = dict(
        inv_mw=col(inv_mw), mw=col(packed.mw), T_mid=col(packed.T_mid),
        a_lo=f(packed.a_lo), a_hi=f(packed.a_hi),
        nu_net_T=f(np.asarray(packed.nu_net, np.float64).T),
        nu_net=f(packed.nu_net), sum_nu=col(packed.sum_nu),
        logA=col(packed.logA), beta=col(packed.beta), Ta=col(packed.Ta),
        rev_mask=col(packed.rev_mask), A_sign=col(packed.A_sign),
        reac_sp=idx(packed.reac_sp), prod_sp=idx(packed.prod_sp),
        reac_nu=f(reac_nu), prod_nu=f(prod_nu),
        ordf=col(reac_nu.sum(1)), ordr=col(prod_nu.sum(1)),
        u_vec=f(inv_mw[:-1] - inv_mw[-1]), winv=f(inv_mw[:-1]),
        eff_m1=f(eff_m1), alpha_tilde=f(alpha_tilde), pd_tilde=f(pd_tilde),
        pd=idx(np.maximum(pd, 0)), spec_mask=col(pd >= 0),
        thd_mask=col(packed.thd_only_mask), fall_mask=col(packed.falloff_mask),
        chem_mask=col(packed.chemact_mask),
        pdep_mask=col(np.asarray(packed.falloff_mask) |
                      np.asarray(packed.chemact_mask)),
        low_logA=col(packed.low_logA), low_beta=col(packed.low_beta),
        low_Ta=col(packed.low_Ta), high_logA=col(packed.high_logA),
        high_beta=col(packed.high_beta), high_Ta=col(packed.high_Ta),
        troe_mask=col(troe), troe_a=col(packed.troe_par[:, 0]),
        troe_T3=col(np.where(troe, packed.troe_par[:, 1], 1.0)),
        troe_T1=col(np.where(troe, packed.troe_par[:, 2], 1.0)),
        troe_T2=col(packed.troe_par[:, 3]), troe_has2=col(packed.troe_has_T2),
        sri_mask=col(sri), sri_a=col(packed.sri_par[:, 0]),
        sri_b=col(packed.sri_par[:, 1]),
        sri_c=col(np.where(sri, packed.sri_par[:, 2], 1.0)),
        sri_d=col(packed.sri_par[:, 3]), sri_e=col(packed.sri_par[:, 4]))
    Sf, Sp = reac_nu.shape[1], prod_nu.shape[1]
    # the slots that hit the eliminated species N - 1
    c['last_f'] = f(np.asarray(packed.reac_sp) == N - 1)
    c['last_p'] = f(np.asarray(packed.prod_sp) == N - 1)
    if packed.has_plog:
        mask = np.zeros(R)
        mask[np.asarray(packed.plog_idx)] = 1.0
        c.update(plog_idx=idx(packed.plog_idx), plog_mask=col(mask),
                 plog_n=col(packed.plog_n), plog_lnP=f(packed.plog_lnP),
                 plog_logA=f(packed.plog_logA), plog_beta=f(packed.plog_beta),
                 plog_Ta=f(packed.plog_Ta))
    if packed.has_cheb:
        mask = np.zeros(R)
        mask[np.asarray(packed.cheb_idx)] = 1.0
        tlim, plim = np.asarray(packed.cheb_tlim), np.asarray(packed.cheb_plim)
        c.update(cheb_idx=idx(packed.cheb_idx), cheb_mask=col(mask),
                 cheb_tsum=col(tlim[:, 0]), cheb_tsub=col(tlim[:, 1]),
                 cheb_psum=col(plim[:, 0]), cheb_psub=col(plim[:, 1]),
                 cheb_coef=f(packed.cheb_coef))
    frac = lambda nu: [bool((nu[:, i] != np.round(nu[:, i])).any())
                       for i in range(nu.shape[1])]
    meta = dict(N=N, R=R, Sf=Sf, Sp=Sp, J=J, frac_f=frac(reac_nu),
                frac_p=frac(prod_nu), max_nu=packed.max_nu_int,
                has_rev=packed.has_rev, has_pres_mod=packed.has_pres_mod,
                has_troe=packed.has_troe, has_sri=packed.has_sri,
                has_chemact=packed.has_chemact,
                has_spec_pdep=packed.has_specific_pdep_sp,
                has_troe2=bool(np.asarray(packed.troe_has_T2).any()),
                has_neg_A=packed.has_negative_A, has_plog=packed.has_plog,
                has_cheb=packed.has_cheb)
    return c, meta


def _scatter(rows, x, R):
    """(R, B) zeros with ``x`` (len(rows), B) in ``rows`` (the TPU
    kernel's ``scat @ x`` one-hot matmul)."""
    out = torch.zeros((R, x.shape[-1]), dtype=x.dtype, device=x.device)
    return out.index_copy(0, rows, x)


def mean_weight(C, Yr):
    """The full mass fractions (N, B), the last species' 1 - sum(Y), and
    1 / W_bar (1, B), as JAX's kernel sums them (a reduction and a
    product with the inverse weights)."""
    y_N = 1.0 - Yr.sum(0, keepdim=True)
    Y_full = torch.cat([Yr, y_N], 0)
    return Y_full, C['inv_mw'].T @ Y_full


def _compute(C, meta, y, P_in, conp):
    """``pallas_jacobian._compute`` in float32 on (N, B) states ``y`` and
    the (1, B) pressure (CONP) or density (CONV) row ``P_in``."""
    N, R, Sf, Sp, J = (meta[k] for k in ('N', 'R', 'Sf', 'Sp', 'J'))
    T = y[0:1]
    Yr = y[1:]
    logT = torch.log(T)
    invT = 1.0 / T
    Y_full, inv_wbar = mean_weight(C, Yr)
    mw_avg = 1.0 / inv_wbar
    if conp:
        P = P_in
        rho = P * mw_avg / (RU * T)
    else:
        rho = P_in
        P = rho * RU * T * inv_wbar
    conc = rho * Y_full * C['inv_mw']

    # --- thermo (two-range NASA select), all (N, B) --------------------------
    sel = T <= C['T_mid']

    def dual(poly):
        return torch.where(sel, poly(C['a_lo']), poly(C['a_hi']))

    def a_(a, i):
        return a[:, i:i + 1]

    def poly_cp(a):
        return a_(a, 0) + T * (a_(a, 1) + T * (a_(a, 2) + T * (
            a_(a, 3) + a_(a, 4) * T)))

    def poly_h(a):
        return a_(a, 5) + T * (a_(a, 0) + T * (a_(a, 1) / 2 + T * (
            a_(a, 2) / 3 + T * (a_(a, 3) / 4 + a_(a, 4) / 5 * T))))

    def poly_smh(a):
        return (a_(a, 0) * (logT - 1.0) + T * (a_(a, 1) / 2 + T * (
            a_(a, 2) / 6 + T * (a_(a, 3) / 12 + a_(a, 4) / 20 * T)))
            - a_(a, 5) * invT + a_(a, 6))

    def poly_dsmh(a):
        return (a_(a, 0) * invT + a_(a, 1) / 2 + T * (a_(a, 2) / 3 + T * (
            a_(a, 3) / 4 + a_(a, 4) / 5 * T)) + a_(a, 5) * invT * invT)

    def poly_dcp(a):
        return a_(a, 1) + T * (2 * a_(a, 2) + T * (3 * a_(a, 3) +
                                                    4 * a_(a, 4) * T))

    RUinv_mw = RU * C['inv_mw']
    cp = RUinv_mw * dual(poly_cp)
    h = RUinv_mw * dual(poly_h)
    if not conp:
        cp = cp - RUinv_mw
        h = h - RUinv_mw * T
    dcp = RUinv_mw * dual(poly_dcp)
    smh = dual(poly_smh)
    dsmh = dual(poly_dsmh)

    # --- forward / reverse rate constants, (R, B) ----------------------------
    kf = torch.exp(C['logA'] + C['beta'] * logT - C['Ta'] * invT)
    if meta['has_neg_A']:
        kf = kf * C['A_sign']
    dlnkf_dT = (C['beta'] + C['Ta'] * invT) * invT
    aP = torch.zeros_like(kf)

    if meta['has_plog']:
        lnP = torch.log(P)
        Pm = C['plog_lnP'].shape[1]
        k_ = lambda name, k: C[name][:, k:k + 1]
        lnks = [k_('plog_logA', k) + k_('plog_beta', k) * logT -
                k_('plog_Ta', k) * invT for k in range(Pm)]
        dlnks = [(k_('plog_beta', k) + k_('plog_Ta', k) * invT) * invT
                 for k in range(Pm)]
        cnt = torch.zeros_like(lnks[0])
        for k in range(Pm):
            cnt = cnt + (lnP > k_('plog_lnP', k)).to(F32)
        n_r = C['plog_n']
        idx_lo = torch.minimum(torch.clamp(cnt - 1.0, min=0.0),
                               torch.clamp(n_r - 2.0, min=0.0))
        idx_hi = torch.minimum(idx_lo + 1.0, n_r - 1.0)

        def pick(fields, idx):
            out = torch.zeros_like(fields[0])
            for k in range(Pm):
                out = out + torch.where(idx == float(k), fields[k], 0.0)
            return out

        lnPs = [k_('plog_lnP', k).expand_as(lnks[0]) for k in range(Pm)]
        lo, hi = pick(lnks, idx_lo), pick(lnks, idx_hi)
        dlo, dhi = pick(dlnks, idx_lo), pick(dlnks, idx_hi)
        P_lo, P_hi = pick(lnPs, idx_lo), pick(lnPs, idx_hi)
        den = P_hi - P_lo
        safe = torch.where(den == 0.0, 1.0, den)
        w_raw = (lnP - P_lo) / safe
        w = torch.clamp(w_raw, 0.0, 1.0)
        interior = ((w_raw > 0.0) & (w_raw < 1.0) & (den != 0.0)).to(F32)
        kf_p = torch.exp(lo + (hi - lo) * w)
        dlnkf_p = dlo + (dhi - dlo) * w
        aP_p = interior * (hi - lo) / safe
        notp = 1.0 - C['plog_mask']
        rows = C['plog_idx']
        kf = kf * notp + _scatter(rows, kf_p, R)
        dlnkf_dT = dlnkf_dT * notp + _scatter(rows, dlnkf_p, R)
        aP = aP + _scatter(rows, aP_p, R)

    if meta['has_cheb']:
        NT, NP = C['cheb_coef'].shape[1:]
        Tred = ((2.0 * invT) - C['cheb_tsum']) / C['cheb_tsub']
        lgP = torch.log(torch.clamp(P, min=TINY32)) / LOG10
        Pred = (2.0 * lgP - C['cheb_psum']) / C['cheb_psub']

        def chebs(x, n):
            ps, ds = [torch.ones_like(x)], [torch.zeros_like(x)]
            if n > 1:
                ps.append(x)
                ds.append(torch.ones_like(x))
            for _ in range(2, n):
                ds.append(2.0 * ps[-1] + 2.0 * x * ds[-1] - ds[-2])
                ps.append(2.0 * x * ps[-1] - ps[-2])
            return ps, ds

        Tp, dTp = chebs(Tred, NT)
        Pp, dPp = chebs(Pred, NP)
        lgk = torch.zeros_like(Tred)
        dlgk_dTred = torch.zeros_like(Tred)
        dlgk_dPred = torch.zeros_like(Tred)
        for i in range(NT):
            for j in range(NP):
                a = C['cheb_coef'][:, i, j:j + 1]
                lgk = lgk + a * Tp[i] * Pp[j]
                dlgk_dTred = dlgk_dTred + a * dTp[i] * Pp[j]
                dlgk_dPred = dlgk_dPred + a * Tp[i] * dPp[j]
        kf_c = torch.exp(LOG10 * lgk)
        dTred_dT = (-2.0 * invT * invT) / C['cheb_tsub']
        dlnkf_c = LOG10 * dlgk_dTred * dTred_dT
        aP_c = LOG10 * dlgk_dPred * (2.0 / (LOG10 * C['cheb_psub']))
        notc = 1.0 - C['cheb_mask']
        rows = C['cheb_idx']
        kf = kf * notc + _scatter(rows, kf_c, R)
        dlnkf_dT = dlnkf_dT * notc + _scatter(rows, dlnkf_c, R)
        aP = aP + _scatter(rows, aP_c, R)

    if meta['has_rev']:
        lnKc = C['nu_net'] @ smh + C['sum_nu'] * (_LN_PA_RU - logT)
        kr = C['rev_mask'] * kf * torch.exp(-lnKc)
        dlnKc_dT = C['nu_net'] @ dsmh - C['sum_nu'] * invT
        dlnkr_dT = dlnkf_dT - dlnKc_dT
    else:
        kr = torch.zeros_like(kf)
        dlnkr_dT = torch.zeros_like(kf)

    # --- slot products and derivatives, (R, B) per slot ----------------------
    def slot_products(sp, nu, frac):
        S = sp.shape[1]
        cgs, pows = [], []
        for si in range(S):
            cg = conc[sp[:, si]]
            nu_s = nu[:, si:si + 1]
            if frac[si]:
                lc = torch.log(torch.clamp(cg, min=TINY32))
                powv = torch.where(nu_s == 0.0, 1.0, torch.exp(nu_s * lc))
            else:
                powv = torch.where(nu_s == 0.0, 1.0, cg)
                acc = cg
                for k in range(2, meta['max_nu'] + 1):
                    acc = acc * cg
                    powv = torch.where(nu_s >= float(k), acc, powv)
            cgs.append(cg)
            pows.append(powv)
        total = pows[0]
        for si in range(1, S):
            total = total * pows[si]
        dvals = []
        for si in range(S):
            cg = cgs[si]
            nu_s = nu[:, si:si + 1]
            if frac[si]:
                lc = torch.log(torch.clamp(cg, min=TINY32))
                dpow = torch.where(nu_s == 0.0, 0.0,
                                   torch.exp((nu_s - 1.0) * lc))
            else:
                dpow = torch.where(nu_s == 0.0, 1.0, cg)
                dacc = cg
                for k in range(2, meta['max_nu']):
                    dacc = dacc * cg
                    dpow = torch.where(nu_s - 1.0 >= float(k), dacc, dpow)
                dpow = torch.where(nu_s <= 1.0,
                                   torch.where(nu_s == 0.0, 0.0, 1.0), dpow)
            excl = None
            for s2 in range(S):
                if s2 != si:
                    excl = pows[s2] if excl is None else excl * pows[s2]
            if excl is None:
                excl = torch.ones_like(total)
            dvals.append(nu_s * dpow * excl)
        return total, dvals

    Pif, dPif = slot_products(C['reac_sp'], C['reac_nu'], meta['frac_f'])
    Pir, dPir = slot_products(C['prod_sp'], C['prod_nu'], meta['frac_p'])
    Rf = kf * Pif
    Rr = kr * Pir
    qnet = Rf - Rr

    # --- pressure modification, (R, B) ---------------------------------------
    pm = torch.ones_like(kf)
    dpm_dT = torch.zeros_like(kf)
    c_u_pm = torch.zeros_like(kf)
    psi = torch.zeros_like(kf)
    xi = torch.zeros_like(kf)
    if meta['has_pres_mod']:
        m_tb = P / (RU * T)
        thd = m_tb + C['eff_m1'] @ conc
        tm = C['thd_mask']
        pm = pm + tm * (thd - 1.0)
        if conp:
            dpm_dT = dpm_dT + tm * (-thd * invT)
            c_u_pm = c_u_pm + tm * (-mw_avg * (thd - m_tb))
        else:
            c_u_pm = c_u_pm + tm * rho
        psi = psi + tm * rho

        fall = C['fall_mask'] > 0.5
        chem = C['chem_mask'] > 0.5
        pdep = C['pdep_mask'] > 0.5
        k0 = torch.where(fall, torch.exp(C['low_logA'] + C['low_beta'] * logT -
                                         C['low_Ta'] * invT), kf)
        dlnk0 = torch.where(fall, (C['low_beta'] + C['low_Ta'] * invT) * invT,
                            dlnkf_dT)
        if meta['has_chemact']:
            kinf = torch.where(chem, torch.exp(C['high_logA'] +
                                               C['high_beta'] * logT -
                                               C['high_Ta'] * invT), kf)
            dlnkinf = torch.where(chem, (C['high_beta'] +
                                         C['high_Ta'] * invT) * invT,
                                  dlnkf_dT)
        else:
            kinf = kf
            dlnkinf = dlnkf_dT
        if meta['has_spec_pdep']:
            sm = C['spec_mask'] > 0.5
            X = torch.where(sm, conc[C['pd']], thd)
        else:
            sm = torch.zeros_like(fall)
            X = thd.expand_as(kf)
        ratio = k0 / kinf
        Pr = ratio * X
        L = torch.log(torch.clamp(Pr, min=TINY32)) / LOG10
        dL_dPr = torch.where(Pr > TINY32,
                             1.0 / (LOG10 * torch.clamp(Pr, min=TINY32)), 0.0)
        F = torch.ones_like(Pr)
        dF_dT = torch.zeros_like(Pr)
        dF_dL = torch.zeros_like(Pr)
        if meta['has_troe']:
            ta = C['troe_a']
            e3 = torch.exp(-T / C['troe_T3'])
            e1 = torch.exp(-T / C['troe_T1'])
            Fc = (1.0 - ta) * e3 + ta * e1
            dFc = -(1.0 - ta) / C['troe_T3'] * e3 - ta / C['troe_T1'] * e1
            if meta['has_troe2']:
                e2 = torch.exp(-C['troe_T2'] * invT)
                Fc = Fc + C['troe_has2'] * e2
                dFc = dFc + C['troe_has2'] * C['troe_T2'] * invT * invT * e2
            cc = torch.log(torch.clamp(Fc, min=TINY32)) / LOG10
            dcc = torch.where(Fc > TINY32,
                              dFc / (LOG10 * torch.clamp(Fc, min=TINY32)), 0.0)
            A_ = L - 0.67 * cc - 0.4
            B_ = 0.806 - 1.1762 * cc - 0.14 * L
            AB = A_ / B_
            g = 1.0 / (1.0 + AB * AB)
            Ft = torch.exp(LOG10 * cc * g)
            dg_dc = (-g * g * 2.0 * AB * ((-0.67) * B_ + 1.1762 * A_) /
                     (B_ * B_))
            dg_dL = -g * g * 2.0 * AB * (B_ + 0.14 * A_) / (B_ * B_)
            tmask = C['troe_mask'] > 0.5
            F = torch.where(tmask, Ft, F)
            dF_dT = torch.where(tmask, Ft * LOG10 * (g + cc * dg_dc) * dcc,
                                dF_dT)
            dF_dL = torch.where(tmask, Ft * LOG10 * cc * dg_dL, dF_dL)
        if meta['has_sri']:
            eb = torch.exp(-C['sri_b'] * invT)
            ec = torch.exp(-T / C['sri_c'])
            base = torch.clamp(C['sri_a'] * eb + ec, min=TINY32)
            Xs = 1.0 / (1.0 + L * L)
            Fs = (torch.exp(Xs * torch.log(base)) * C['sri_d'] *
                  torch.exp(C['sri_e'] * logT))
            dbase = (C['sri_a'] * C['sri_b'] * invT * invT * eb -
                     ec / C['sri_c'])
            smask = C['sri_mask'] > 0.5
            F = torch.where(smask, Fs, F)
            dF_dT = torch.where(smask, Fs * (Xs * dbase / base +
                                             C['sri_e'] * invT), dF_dT)
            dF_dL = torch.where(smask, Fs * torch.log(base) *
                                (-2.0 * L * Xs * Xs), dF_dL)

        G_ = torch.where(fall, Pr / (1.0 + Pr), 1.0 / (1.0 + Pr))
        dG_dPr = torch.where(fall, 1.0, -1.0) / ((1.0 + Pr) * (1.0 + Pr))
        Phi = F * dG_dPr + G_ * dF_dL * dL_dPr
        if conp:
            dPr_dT = Pr * (dlnk0 - dlnkinf - invT)
        else:
            dPr_dT = Pr * (dlnk0 - dlnkinf)
        pm = torch.where(pdep, F * G_, pm)
        dpm_dT = torch.where(pdep, G_ * dF_dT + Phi * dPr_dT, dpm_dT)
        if conp:
            cu_mix = -mw_avg * (thd - m_tb)
        else:
            cu_mix = rho.expand_as(thd)
        if meta['has_spec_pdep']:
            cu_spec = -mw_avg * X if conp else torch.zeros_like(X)
            cu_X = torch.where(sm, cu_spec, cu_mix)
        else:
            cu_X = cu_mix.expand_as(kf)
        c_u_pm = torch.where(pdep, Phi * ratio * cu_X, c_u_pm)
        psi = torch.where(pdep, torch.where(sm, 0.0, Phi * ratio * rho), psi)
        if meta['has_spec_pdep']:
            xi = torch.where(pdep & sm, Phi * ratio * rho, xi)

    # --- dq/dT, (R, B) -------------------------------------------------------
    dq_dT = pm * (Rf * dlnkf_dT - Rr * dlnkr_dT) + dpm_dT * qnet
    if conp:
        dq_dT = dq_dT + pm * (-invT) * (C['ordf'] * Rf - C['ordr'] * Rr)
    elif meta['has_plog'] or meta['has_cheb']:
        dq_dT = dq_dT + pm * qnet * aP * invT

    # --- the column operands' parts ------------------------------------------
    pmrho = pm * rho
    vals_f = [pmrho * kf * dPif[s] for s in range(Sf)]
    vals_p = [pmrho * kr * dPir[s] for s in range(Sp)]
    c_1 = torch.zeros_like(kf)
    w_last = C['inv_mw'][N - 1, 0]
    for s in range(Sf):
        c_1 = c_1 - vals_f[s] * C['last_f'][:, s:s + 1] * w_last
    for s in range(Sp):
        c_1 = c_1 + vals_p[s] * C['last_p'][:, s:s + 1] * w_last
    c_u = c_u_pm * qnet
    if conp:
        c_u = c_u + pm * (C['ordf'] * Rf - C['ordr'] * Rr) * (-mw_avg)
    elif meta['has_plog'] or meta['has_cheb']:
        c_u = c_u + pm * qnet * aP * mw_avg

    # --- stoichiometric contractions -----------------------------------------
    nuT = C['nu_net_T']
    omega = nuT @ (pm * qnet)
    domega_dT = nuT @ dq_dT
    v_u = nuT @ c_u
    v_1 = nuT @ c_1

    # --- thermodynamic closure -----------------------------------------------
    rho_inv = 1.0 / rho
    mw = C['mw']
    fk = omega * mw * rho_inv
    sh = (cp * Y_full).sum(0, keepdim=True)
    dsh_dT = (dcp * Y_full).sum(0, keepdim=True)
    eW = h * mw
    denomT = rho * sh
    fT = -(eW * omega).sum(0, keepdim=True) / denomT
    dlnrho_dT = -invT if conp else torch.zeros_like(invT)
    JYT = mw[:J] * rho_inv * domega_dT[:J] - fk[:J] * dlnrho_dT
    JTT = (-((cp * mw * omega).sum(0, keepdim=True) +
             (eW * domega_dT).sum(0, keepdim=True)) / denomT -
           fT * (dlnrho_dT + dsh_dT / sh))
    return dict(col0=torch.cat([JTT, JYT], 0), f=torch.cat([fT, fk[:J]], 0),
                vals_f=vals_f, vals_p=vals_p, psi_q=psi * qnet,
                xi_q=xi * qnet, v_u=v_u, v_1=v_1, rho_inv=rho_inv, fk=fk,
                eW=eW, denomT=denomT, sh=sh, cp=cp, mw_avg=mw_avg, fT=fT)


def f32_reference(packed, y_t, P_t, conp: bool = True):
    """Plain PyTorch version of the K3 kernel: ``_compute`` in float32,
    then ``_kernel``'s column loop.

    ``y_t`` (N, B) and ``P_t`` (1, B) float32, batch-minor; ``P_t`` is
    pressure (CONP) or density (CONV).  Returns ``Jt`` (N, N, B) in the
    TPU kernel's [column, row, batch] layout, column 0 the temperature
    column, and dy/dt ``f`` (N, B), both float32."""
    C, meta = cached(packed, ('f32_consts', str(y_t.device)),
                     lambda: _consts(packed, y_t.device))
    N, J, Sf, Sp = meta['N'], meta['J'], meta['Sf'], meta['Sp']
    p = _compute(C, meta, y_t, P_t, conp)
    B = y_t.shape[-1]
    Jt = torch.empty((N, N, B), dtype=F32, device=y_t.device)
    Jt[0] = p['col0']
    nuT, cp = C['nu_net_T'], p['cp']
    cp_N = cp[J:N]
    mwJ = C['mw'][:J]
    sp_f, sp_p = C['reac_sp'], C['prod_sp']
    for j in range(J):
        # column j of each slot's scatter mask (the one-hot W_s)
        mf = (sp_f == j).to(F32)
        mp = (sp_p == j).to(F32)
        P1 = p['vals_f'][0] * mf[:, 0:1]
        for s in range(1, Sf):
            P1 = P1 + p['vals_f'][s] * mf[:, s:s + 1]
        for s in range(Sp):
            P1 = P1 - p['vals_p'][s] * mp[:, s:s + 1]
        P1 = P1 * C['winv'][j]
        if meta['has_pres_mod']:
            P1 = P1 + p['psi_q'] * C['alpha_tilde'][:, j:j + 1]
            if meta['has_spec_pdep']:
                P1 = P1 + p['xi_q'] * C['pd_tilde'][:, j:j + 1]
        u_j = C['u_vec'][j]
        dcol = nuT @ P1
        dcol = dcol + p['v_u'] * u_j + p['v_1']
        r_j = -p['mw_avg'] * u_j if conp else torch.zeros_like(p['mw_avg'])
        Jt[j + 1, 1:] = mwJ * p['rho_inv'] * dcol[:J] - p['fk'][:J] * r_j
        Jt[j + 1, :1] = (-(p['eW'] * dcol).sum(0, keepdim=True) /
                         p['denomT'] -
                         p['fT'] * (r_j + (cp[j:j + 1] - cp_N) / p['sh']))
    return Jt, p['f']


def f32_tables(packed) -> dict:
    """The K3 kernel's tables: K4's (``jacobian_big.parts_tables``, then
    ``jacobian_dense.fused_tables``, in the C struct ``DenseTables``'
    order), the float arrays as float32, the index arrays int32."""
    out = {}
    for prefix, tabs in (('kp_', parts_tables(packed)),
                         ('kf_', fused_tables(packed))):
        for name, arr in tabs.items():
            out[prefix + name] = (arr.astype(np.float32)
                                  if arr.dtype == np.float64 else arr)
    return out


def _as_f32(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(dtype=F32, device=device)


class F32Jacobian(nn.Module):
    """float32 analytical Jacobian + dy/dt in one fused kernel — the port
    of ``PallasJacobian``.

    The tables are registered buffers, so ``.to(device)`` moves them.
    On CUDA tensors every call launches K3 (or raises); on CPU tensors it
    runs :func:`f32_reference`.  A mechanism :func:`supports` refuses
    raises ``NotImplementedError``.
    """

    # K3's tables are K4's, the float ones in float32
    INT_TABLES = DenseJacobian.INT_TABLES
    TILE_KERNEL = 'fused_f32'

    def __init__(self, packed, conp: bool = True, device='cuda'):
        super().__init__()
        device = entry_device(device)
        if not supports(packed):
            raise NotImplementedError(
                'sign-flipping PLOG tables are outside F32Jacobian\'s '
                'coverage (as PallasJacobian)')
        self.packed = packed
        self.conp = bool(conp)
        self.N, self.R = packed.n_species, packed.n_reactions
        self.J = self.N - 1
        self.register_buffer('inv_mw', torch.as_tensor(
            np.asarray(packed.inv_mw, np.float32)))
        for name, arr in f32_tables(packed).items():
            self.register_buffer(name, torch.as_tensor(arr))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.inv_mw.device

    def call_tr(self, y_t, P_t):
        """Batch-minor entry point: ``y_t`` (N, B), ``P_t`` (1, B)
        float32 tensors on the module's device (pressure under CONP,
        density under CONV).  Returns ``Jt`` (N, N, B), [column, row,
        batch], and dy/dt ``f`` (N, B), float32.  One span
        ``pyjac.jacobian``."""
        with span('pyjac.jacobian'):
            if y_t.device.type == 'cpu':
                return f32_reference(self.packed, y_t, P_t, self.conp)
            return kernels.fused_f32(self, y_t, P_t)

    def forward(self, y, P):
        """Batch-major: ``y`` (B, N), ``P`` scalar or (B,), cast to
        float32 -> ``J`` (B, N, N) with ``J[b, i, j] = d f_i / d y_j`` and
        ``f`` (B, N), float32 on the module's device."""
        check_state_width(y, self.N, 'F32Jacobian')
        y = _as_f32(y, self.device)
        P = torch.broadcast_to(_as_f32(P, self.device), y.shape[:1])
        Jt, f = self.call_tr(y.T.contiguous(), P[None].contiguous())
        return Jt.permute(2, 1, 0), f.T
