"""Plain PyTorch reference: CONP kinetics of a Chemkin mechanism, its
Jacobian by forward-mode autodiff, and a plain ROS23 integrator.

Written for the benchmark from the Chemkin and NASA-7 definitions (the
pyJac paper, Niemeyer et al., CPC 2017, arXiv:1605.03262, section 2),
independent of the program it judges: it imports nothing of the program,
parses the mechanism text itself and derives every table again.  It
covers the reaction categories of the configurations that name it:
reversible and irreversible Arrhenius reactions, duplicates, third-body
reactions with efficiencies, Lindemann and Troe falloff.  A mechanism
with any other category (PLOG, Chebyshev, SRI, HIGH, REV, a species as
the falloff collider, fractional coefficients) is refused; a
configuration that needs one names a reference file of its own.

State: ``y = [T, Y_1 .. Y_{N-1}]`` with the last species' mass fraction
``1 - sum(Y)``; pressure in Pa; SI units with kmol (the program's and
pyJac's convention).  The Jacobian is ``J[i, j] = d f_i / d y_j`` of
:func:`dydt`, taken by ``torch.func.jacfwd`` (the autodiff reference
pyJac validated against).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

RU = 8314.4621            # J / (kmol K)
PA = 101325.0             # Pa, the standard-state pressure
CAL = 4.184 / 8.3144621   # K per (cal/mol)
ELEMENT_WEIGHT = {'H': 1.00794, 'C': 12.0110, 'N': 14.00674,
                  'O': 15.99940, 'AR': 39.94800, 'HE': 4.00260}
_UNSUPPORTED = ('PLOG', 'CHEB', 'PCHEB', 'TCHEB', 'SRI', 'HIGH', 'REV',
                'FORD', 'RORD', 'UNITS')


class Mechanism:
    """The numbers of a Chemkin mechanism text, as numpy arrays.

    Species keep the file's order; the eliminated species is the last
    one, which the configurations put last (N2).  Reactions keep the
    file's order.  Pre-exponentials are converted from cm, mol to m,
    kmol; activation energies from cal/mol to K."""

    def __init__(self, text: str):
        sections = _sections(text)
        self.species = sections['SPECIES'].split()
        self.N = len(self.species)
        index = {s: k for k, s in enumerate(self.species)}
        self._thermo(sections['THERMO'], index)
        reacs = _reactions(sections['REACTIONS'])
        R = self.R = len(reacs)
        N = self.N
        self.nu_f = np.zeros((R, N))
        self.nu_r = np.zeros((R, N))
        self.logA = np.zeros(R)
        self.beta = np.zeros(R)
        self.Ta = np.zeros(R)
        self.rev = np.zeros(R, bool)
        self.thd = np.zeros(R, bool)
        self.fall = np.zeros(R, bool)
        self.eff = np.ones((R, N))
        self.low = np.zeros((R, 3))
        self.troe = np.zeros(R, bool)
        self.troe_T2 = np.zeros(R, bool)
        self.troe_par = np.ones((R, 4))
        for r, rx in enumerate(reacs):
            for sp, nu in rx['reac'].items():
                self.nu_f[r, index[sp]] = nu
            for sp, nu in rx['prod'].items():
                self.nu_r[r, index[sp]] = nu
            order = sum(rx['reac'].values())
            # one more concentration multiplies a third-body rate
            self.logA[r] = math.log(rx['A'] / 1000.0 ** (
                order - (0.0 if rx['thd'] else 1.0)))
            self.beta[r] = rx['b']
            self.Ta[r] = rx['E'] * CAL
            self.rev[r] = rx['rev']
            self.thd[r] = rx['thd']
            self.fall[r] = rx['fall']
            for sp, alpha in rx['eff'].items():
                self.eff[r, index[sp]] = alpha
            if rx['low'] is not None:
                A0, b0, E0 = rx['low']
                self.low[r] = (math.log(A0 / 1000.0 ** order), b0, E0 * CAL)
            if rx['troe'] is not None:
                p = rx['troe']
                self.troe[r] = True
                self.troe_T2[r] = len(p) > 3
                self.troe_par[r, :len(p)] = p
        self.nu_net = self.nu_r - self.nu_f
        self.sum_nu = self.nu_net.sum(1)

    def _thermo(self, block: str, index: Dict[str, int]):
        lines = [ln for ln in block.splitlines() if ln.strip()]
        # the first line holds the default temperature ranges
        lines = lines[1:] if not lines[0].rstrip().endswith('1') else lines
        N = self.N
        self.W = np.zeros(N)
        self.a_lo = np.zeros((N, 7))
        self.a_hi = np.zeros((N, 7))
        self.T_mid = np.zeros(N)
        seen = set()
        for i in range(0, len(lines), 4):
            l1, l2, l3, l4 = lines[i:i + 4]
            name = l1[:18].split()[0]
            if name not in index:
                continue
            k = index[name]
            seen.add(name)
            comp = l1[24:44]
            w = 0.0
            for j in range(0, 20, 5):
                el, cnt = comp[j:j + 2].strip(), comp[j + 2:j + 5].strip()
                if el and cnt and int(float(cnt)):
                    w += ELEMENT_WEIGHT[el.upper()] * int(float(cnt))
            self.W[k] = w
            self.T_mid[k] = float(l1[45:].split()[2])
            f = [float(ln[c:c + 15]) for ln in (l2, l3, l4)
                 for c in range(0, 75, 15) if ln[c:c + 15].strip()]
            self.a_hi[k] = f[0:7]
            self.a_lo[k] = f[7:14]
        missing = set(self.species) - seen
        if missing:
            raise ValueError('no thermo for %s' % sorted(missing))

    def tensors(self, device, dtype=torch.float64,
                tf32: bool = False) -> Dict[str, torch.Tensor]:
        """The arrays :func:`dydt` reads, on ``device`` in ``dtype``;
        the stoichiometry as slot lists (species index, coefficient) of
        every reaction's reactants and products.  ``tf32`` rounds the
        operands of the three contractions to TF32 (the control of a
        float32 cell)."""
        def slots(nu):
            S = max(1, int((nu > 0).sum(1).max()))
            idx = np.zeros((self.R, S), np.int64)
            val = np.zeros((self.R, S))
            for r in range(self.R):
                z = np.nonzero(nu[r])[0]
                idx[r, :len(z)] = z
                val[r, :len(z)] = nu[r, z]
            return idx, val
        fi, fv = slots(self.nu_f)
        ri, rv = slots(self.nu_r)
        f = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=device).to(dtype)
        b = lambda a: torch.as_tensor(np.asarray(a), device=device)
        return dict(
            inv_W=f(1.0 / self.W), a_lo=f(self.a_lo), a_hi=f(self.a_hi),
            T_mid=f(self.T_mid), logA=f(self.logA), beta=f(self.beta),
            Ta=f(self.Ta), nu_net=f(self.nu_net), sum_nu=f(self.sum_nu),
            rev=b(self.rev), thd=b(self.thd), fall=b(self.fall),
            eff_m1=f(self.eff - 1.0), low=f(self.low), troe=b(self.troe),
            troe_T2=b(self.troe_T2), troe_par=f(self.troe_par),
            f_idx=b(fi), f_nu=f(fv), r_idx=b(ri), r_nu=f(rv),
            max_nu=int(max(fv.max(), rv.max())), tf32=bool(tf32))


def _sections(text: str) -> Dict[str, str]:
    out, key, buf = {}, None, []
    for line in text.splitlines():
        line = line.split('!')[0].rstrip()
        word = line.strip().split()[0].upper() if line.strip() else ''
        if key is None:
            if word[:4] in ('ELEM', 'SPEC', 'THER', 'REAC'):
                key = {'ELEM': 'ELEMENTS', 'SPEC': 'SPECIES',
                       'THER': 'THERMO', 'REAC': 'REACTIONS'}[word[:4]]
                if key == 'REACTIONS' and len(line.split()) > 1:
                    raise NotImplementedError('REACTIONS units: %s' % line)
                buf = []
                if key == 'THERMO':
                    continue
            continue
        if word == 'END':
            out[key] = '\n'.join(buf)
            key = None
            continue
        buf.append(line)
    return out


def _side(side: str):
    """{species: coefficient} of one side and whether '+M' is on it."""
    nus, thd = {}, False
    for tok in side.split('+'):
        tok = tok.strip()
        if not tok:
            continue
        m = re.match(r'^(\d+)?(.+)$', tok)
        nu = float(m.group(1)) if m.group(1) else 1.0
        name = m.group(2)
        if name.upper() == 'M':
            thd = True
            continue
        nus[name] = nus.get(name, 0.0) + nu
    return nus, thd


def _reactions(block: str):
    out = []
    for line in block.splitlines():
        if not line.strip():
            continue
        words = line.replace('/', ' ').split()
        key = words[0].upper()
        if '=' in line.split('/')[0] and len(line.split()) >= 4:
            eq = ''.join(line.split()[:-3])
            A, b, E = (float(x) for x in line.split()[-3:])
            rev = '<=>' in eq or ('=>' not in eq)
            lhs, rhs = re.split(r'<=>|=>|=', eq, maxsplit=1)
            fall = '(+M)' in lhs.upper()
            if re.search(r'\(\+(?!M\))', lhs, re.I):
                raise NotImplementedError('a species as falloff collider')
            lhs = re.sub(r'\(\+M\)', '', lhs, flags=re.I)
            rhs = re.sub(r'\(\+M\)', '', rhs, flags=re.I)
            reac, thd_l = _side(lhs)
            prod, thd_r = _side(rhs)
            if any(nu != int(nu) for nu in [*reac.values(), *prod.values()]):
                raise NotImplementedError('fractional coefficients')
            out.append(dict(reac=reac, prod=prod, A=A, b=b, E=E, rev=rev,
                            thd=(thd_l or thd_r) and not fall, fall=fall,
                            eff={}, low=None, troe=None))
        elif key.startswith('DUP'):
            continue
        elif key == 'LOW':
            out[-1]['low'] = [float(x) for x in words[1:4]]
        elif key == 'TROE':
            out[-1]['troe'] = [float(x) for x in words[1:5]]
        elif key in _UNSUPPORTED:
            raise NotImplementedError('reaction category %s' % key)
        else:
            for sp, alpha in zip(words[0::2], words[1::2]):
                out[-1]['eff'][sp] = float(alpha)
    for rx in out:
        if rx['fall'] and rx['low'] is None:
            raise ValueError('falloff reaction without LOW')
    return out


# ---------------------------------------------------------------------------
# dy/dt of one state
# ---------------------------------------------------------------------------

def _tf32(x):
    """float32 ``x`` rounded to TF32's 11 significant bits (Veltkamp's
    split), with the derivative 1."""
    p = x * 8193.0
    return p - (p - x)


def _mm(t, a, b):
    """The contraction ``a @ b``; with ``t['tf32']`` its operands are
    rounded as the tensor cores' TF32 mode rounds them, on any device."""
    if t['tf32']:
        a, b = _tf32(a), _tf32(b)
    return a @ b


def _powers(C, idx, nu, max_nu: int):
    """prod over slots of C[idx] ** nu, by repeated products (integer
    coefficients; no power of a zero or negative concentration)."""
    c = C[idx]
    term = torch.where(nu >= 1.0, c, torch.ones_like(c))
    acc = c
    for k in range(2, max_nu + 1):
        acc = acc * c
        term = torch.where(nu >= float(k), acc, term)
    return term.prod(-1)


def _terms(t, y, P):
    """(q, |q| by direction, h / RT, cp / R, rho, Y, T) of one state.
    Every value is at least one-dimensional: forward-mode autodiff
    promotes a float scalar times a 0-d float32 tensor to float64."""
    T, Yr = y[:1], y[1:]
    P = P.reshape(1)
    Y = torch.cat([Yr, 1.0 - Yr.sum(-1, keepdim=True)])
    inv_W = t['inv_W']
    rho = P / (RU * T * (Y * inv_W).sum(-1, keepdim=True))
    C = rho * Y * inv_W
    logT = torch.log(T)
    a = torch.where((T <= t['T_mid'])[:, None], t['a_lo'], t['a_hi'])
    a0, a1, a2, a3, a4, a5, a6 = a.unbind(-1)
    cp_R = a0 + T * (a1 + T * (a2 + T * (a3 + a4 * T)))
    h_RT = a0 + T * (a1 / 2 + T * (a2 / 3 + T * (a3 / 4 + a4 * T / 5))) \
        + a5 / T
    s_R = a0 * logT + T * (a1 + T * (a2 / 2 + T * (a3 / 3 + a4 * T / 4))) \
        + a6
    kf = torch.exp(t['logA'] + t['beta'] * logT - t['Ta'] / T)
    ln_kc = _mm(t, t['nu_net'], s_R - h_RT) + t['sum_nu'] * (
        math.log(PA / RU) - logT)
    kr = torch.where(t['rev'], kf * torch.exp(-ln_kc), torch.zeros_like(kf))
    fwd = kf * _powers(C, t['f_idx'], t['f_nu'], t['max_nu'])
    rev = kr * _powers(C, t['r_idx'], t['r_nu'], t['max_nu'])

    M = P / (RU * T) + _mm(t, t['eff_m1'], C)
    low = t['low']
    k0 = torch.exp(low[:, 0] + low[:, 1] * logT - low[:, 2] / T)
    Pr = torch.where(t['fall'], k0 * M / kf, torch.ones_like(kf))
    tp = t['troe_par']
    Fc = (1.0 - tp[:, 0]) * torch.exp(-T / tp[:, 1]) + \
        tp[:, 0] * torch.exp(-T / tp[:, 2])
    Fc = Fc + torch.where(t['troe_T2'], torch.exp(-tp[:, 3] / T),
                          torch.zeros_like(Fc))
    log_fc = torch.log10(torch.where(t['troe'], Fc, torch.ones_like(Fc)))
    x = torch.log10(Pr) - 0.4 - 0.67 * log_fc
    nn = 0.75 - 1.27 * log_fc
    F = torch.pow(10.0, log_fc / (1.0 + (x / (nn - 0.14 * x)) ** 2))
    pm = torch.where(t['fall'], F * Pr / (1.0 + Pr),
                     torch.where(t['thd'], M, torch.ones_like(M)))
    return (pm * (fwd - rev), pm.abs() * (fwd.abs() + rev.abs()), h_RT,
            cp_R, rho, Y, T)


def _dydt1(t, y, P):
    q, _, h_RT, cp_R, rho, Y, T = _terms(t, y, P)
    omega = _mm(t, q, t['nu_net'])
    cp_mass = RU * (cp_R * t['inv_W'] * Y).sum(-1, keepdim=True)
    dT = -(RU * T * h_RT * omega).sum(-1, keepdim=True) / (rho * cp_mass)
    dY = omega[:-1] / (t['inv_W'][:-1] * rho)
    return torch.cat([dT, dY])


def _scale1(t, y, P):
    """The magnitudes of dy/dt's terms: each row's sum of |term|, with
    the enthalpies of the temperature row's species taken apart."""
    _, qa, h_RT, cp_R, rho, Y, T = _terms(t, y, P)
    nu = t['nu_net'].abs()
    cp_mass = RU * (cp_R * t['inv_W'] * Y).sum(-1, keepdim=True)
    dT = (qa @ (nu * (RU * T * h_RT).abs())).sum(-1, keepdim=True) / (
        rho * cp_mass)
    dY = (qa @ nu)[:-1] / (t['inv_W'][:-1] * rho)
    return torch.cat([dT, dY])


def dydt(t, y, P):
    """dy/dt (B, N) of states ``y`` (B, N) at pressures ``P`` (B,)."""
    return torch.func.vmap(lambda a, b: _dydt1(t, a, b))(y, P)


def dydt_scale(t, y, P):
    """The rounding scale of :func:`dydt`'s rows, (B, N)."""
    return torch.func.vmap(lambda a, b: _scale1(t, a, b))(y, P)


def jacobian(t, y, P):
    """J (B, N, N), ``J[b, i, j] = d f_i / d y_j``, and f (B, N)."""
    def one(a, b):
        return torch.func.jacfwd(lambda v: _dydt1(t, v, b))(a)
    return torch.func.vmap(one)(y, P), dydt(t, y, P)


# ---------------------------------------------------------------------------
# ROS23 (ode23s of Shampine & Reichelt 1997) with a per-state step
# ---------------------------------------------------------------------------

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)


def integrate(t, y0, P, t_end: float, rtol: float, atol: float,
              max_steps: int = 100000, max_iterations: int = 0):
    """Integrate every state of ``y0`` (B, N) from 0 to ``t_end`` with
    ROS23 and the stage Jacobian of :func:`jacobian`, each state on its
    own adaptive step (first step ``t_end * 1e-6``; the error is the RMS
    over components of the embedded estimate against ``atol + rtol *
    max(|y|, |y_new|)``; accepted where it is at most 1; the next step
    ``h * clamp(0.9 err^(-1/3), 0.2, 5)``, halved again after a
    rejection).  A state fails where a rejected step falls below
    ``1e-14 t_end``.  Returns (y, status): 0 reached t_end, 1 the step
    underflowed, 2 the attempt budget ran out, 3 the loop's bound of
    ``2 max_steps`` iterations (or ``max_iterations``) cut it off."""
    B, N = y0.shape
    dev, dt = y0.device, y0.dtype
    y = y0.clone()
    tt = torch.zeros(B, dtype=dt, device=dev)
    h = torch.full((B,), t_end * 1e-6, dtype=dt, device=dev)
    attempts = torch.zeros(B, dtype=torch.int64, device=dev)
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    eye = torch.eye(N, dtype=dt, device=dev)
    f = lambda v: dydt(t, v, P)
    for _ in range(max_iterations or 2 * max_steps):
        active = (tt < t_end) & ~failed & (attempts < max_steps)
        if not bool(active.any()):
            break
        hs = torch.where(active, torch.minimum(h, t_end - tt),
                         torch.ones_like(h))
        Jy, F0 = jacobian(t, y, P)
        LU, piv, info = torch.linalg.lu_factor_ex(
            eye - (hs * _D)[:, None, None] * Jy)

        def solve(rhs):
            return torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
        k1 = solve(F0)
        F1 = f(y + 0.5 * hs[:, None] * k1)
        k2 = solve(F1 - k1) + k1
        y_new = y + hs[:, None] * k2
        F2 = f(y_new)
        k3 = solve(F2 - _E32 * (k2 - F1) - 2.0 * (k1 - F0))
        err_vec = (hs / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        err = torch.sqrt(torch.mean((err_vec / scale) ** 2, dim=-1))
        err = torch.where(torch.isfinite(err) & (info == 0), err,
                          torch.full_like(err, math.inf))
        accept = (err <= 1.0) & active
        factor = torch.clamp(0.9 * torch.clamp(err, min=1e-16) ** (-1 / 3),
                             0.2, 5.0)
        h_next = torch.where(accept, hs * factor,
                             hs * torch.clamp(factor, min=0.2) * 0.5)
        h_next = torch.where(torch.isfinite(h_next) & (h_next > 0.0),
                             h_next, hs * 0.5)
        y = torch.where(accept[:, None], y_new, y)
        tt = torch.where(accept, tt + hs, tt)
        failed = failed | (active & (h_next < 1e-14 * t_end) & ~accept)
        h = torch.where(active, h_next, h)
        attempts = attempts + active.to(attempts.dtype)
    done = (tt >= t_end) & ~failed
    status = torch.where(done, 0, torch.where(
        failed, 1, torch.where(attempts >= max_steps, 2, 3)))
    return y, status
