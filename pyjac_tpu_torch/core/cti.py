"""Self-contained Cantera CTI mechanism reader (no Cantera dependency).

The reference delegates ``.cti`` parsing to Cantera
(reference: pyjac/core/mech_interpret.py:886-1129 ``read_mech_ct``); this
module instead executes the CTI file — which is a Python-call DSL — in a
sandboxed namespace that records ``species(...)``, ``reaction(...)``,
``three_body_reaction(...)``, ``falloff_reaction(...)``,
``chemically_activated_reaction(...)``, ``pdep_arrhenius(...)`` and
``chebyshev_reaction(...)`` declarations, producing the same IR as the
Chemkin parser with identical internal units (activation temperature [K],
kmol/m^3 pre-exponentials).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .chemkin import MechanismError, _parse_side, _split_falloff
from .constants import ACT_ENERGY_FACT, PA, get_elem_wt
from .ir import Reaction, Species

# activation-energy unit name (CTI spelling) -> activation temperature [K]
_ACT_FACT = {
    'cal/mol': ACT_ENERGY_FACT['cal/mole'],
    'kcal/mol': ACT_ENERGY_FACT['kcal/mole'],
    'j/mol': ACT_ENERGY_FACT['joules/mole'],
    'kj/mol': ACT_ENERGY_FACT['kjoules/mole'],
    'j/kmol': ACT_ENERGY_FACT['joules/kmole'],
    'k': 1.0,
    'ev': ACT_ENERGY_FACT['evolts'],
}

# decimal exponents so unit factors stay exact powers of ten
_LENGTH_EXP = {'m': 0, 'cm': -2, 'mm': -3}
_QUANTITY_EXP = {'kmol': 0, 'mol': -3}


class _Falloff:
    kind = 'lindemann'


class _Troe(_Falloff):
    kind = 'troe'

    def __init__(self, A=0.0, T3=0.0, T1=0.0, T2=None):
        self.par = [A, T3, T1]
        if T2 is not None:
            self.par.append(T2)


class _SRI(_Falloff):
    kind = 'sri'

    def __init__(self, A=0.0, B=0.0, C=0.0, D=None, E=None):
        self.par = [A, B, C]
        if D is not None or E is not None:
            self.par.append(D if D is not None else 1.0)
            self.par.append(E if E is not None else 0.0)


class _CtiBuilder:
    """Namespace target recording CTI declarations."""

    def __init__(self):
        self.elements: List[str] = []
        self.species_order: List[str] = []
        self.species_map: Dict[str, Species] = {}
        self.reactions: List[Reaction] = []
        self.act_fact = _ACT_FACT['cal/mol']
        # conversion factor: 1 (quantity/length^3) = conc_fact kmol/m^3,
        # kept an exact power of ten (10^3 for mol/cm^3)
        self.conc_fact = 10.0 ** (_QUANTITY_EXP['mol'] - 3 * _LENGTH_EXP['cm'])

    # ---- units ----------------------------------------------------------
    def units(self, length='cm', time='s', quantity='mol',
              act_energy='cal/mol', energy=None, mass=None, pressure=None):
        self.act_fact = _ACT_FACT[act_energy.lower()]
        self.conc_fact = 10.0 ** (_QUANTITY_EXP[quantity.lower()] -
                                  3 * _LENGTH_EXP[length.lower()])

    def _e(self, E) -> float:
        """Activation energy -> activation temperature [K]."""
        if isinstance(E, (tuple, list)):
            val, unit = E
            return val * _ACT_FACT[unit.lower()]
        return E * self.act_fact

    def _a(self, A: float, order: float, offset: float) -> float:
        """Pre-exponential -> kmol/m^3 units.

        Divides by ``conc_fact ** (order - offset)`` exactly as the
        Chemkin path does (reference: mech_interpret.py:441-452), so
        both parsers produce bit-identical constants.
        """
        expo = order - offset
        if expo == 0:
            return A
        if expo > 0:
            return A / self.conc_fact ** expo
        return A * self.conc_fact ** (-expo)

    def _p(self, P) -> float:
        """Pressure (value or (value, unit)) -> Pa."""
        if isinstance(P, (tuple, list)):
            val, unit = P
            u = unit.lower()
            fact = {'atm': PA, 'pa': 1.0, 'bar': 1e5, 'kpa': 1e3,
                    'mpa': 1e6}[u]
            return val * fact
        return P * PA

    # ---- phases / species -----------------------------------------------
    def ideal_gas(self, name='', elements='', species='', reactions='',
                  **kw):
        if not self.elements:
            self.elements = elements.split()
        if not self.species_order:
            self.species_order = species.replace('"', ' ').split()

    def state(self, **kw):
        return kw

    def gas_transport(self, **kw):
        return None

    def NASA(self, Trange, coeffs):
        return ('nasa', list(Trange), list(coeffs))

    def species(self, name, atoms='', thermo=None, transport=None,
                note='', **kw):
        sp = Species(name)
        elem_wt = get_elem_wt()
        for pair in atoms.replace(',', ' ').split():
            el, num = pair.split(':')
            n = int(float(num))
            sp.elem.append([el, n])
            sp.mw += n * elem_wt[el.lower()]
        if thermo is None:
            raise MechanismError('species %s missing thermo' % name)
        polys = [thermo] if isinstance(thermo, tuple) and \
            thermo[0] == 'nasa' else list(thermo)
        polys = sorted(polys, key=lambda p: p[1][0])
        if len(polys) == 1:
            kind, tr, c = polys[0]
            sp.lo = np.asarray(c, dtype=float)
            sp.hi = np.asarray(c, dtype=float)
            sp.Trange = [tr[0], tr[1], tr[1]]
        else:
            k0, tr0, c0 = polys[0]
            k1, tr1, c1 = polys[1]
            sp.lo = np.asarray(c0, dtype=float)
            sp.hi = np.asarray(c1, dtype=float)
            sp.Trange = [tr0[0], tr0[1], tr1[1]]
        self.species_map[name] = sp

    # ---- reactions --------------------------------------------------------
    def _base(self, equation: str):
        eq = equation.replace('<=>', '<=>').strip()
        if '<=>' in eq:
            lhs, rhs = eq.split('<=>', 1)
            rev = True
        elif '=>' in eq:
            lhs, rhs = eq.split('=>', 1)
            rev = False
        else:
            lhs, rhs = eq.split('=', 1)
            rev = True
        lhs, pdep_l, pdep_sp_l = _split_falloff(lhs.strip())
        rhs, pdep_r, pdep_sp_r = _split_falloff(rhs.strip())
        pdep = pdep_l or pdep_r
        pdep_sp = pdep_sp_l or pdep_sp_r
        reac_sp, reac_nu, thd_l = _parse_side(lhs)
        prod_sp, prod_nu, thd_r = _parse_side(rhs)
        thd = (thd_l or thd_r) and not pdep
        return rev, reac_sp, reac_nu, prod_sp, prod_nu, thd, pdep, pdep_sp

    def _effs(self, efficiencies: str):
        out = []
        for pair in efficiencies.replace(',', ' ').split():
            sp, val = pair.split(':')
            out.append([sp, float(val)])
        return out

    def _apply_options(self, rxn: Reaction, options) -> bool:
        if options is None:
            return True
        opts = [options] if isinstance(options, str) else list(options)
        opts = [o.lower() for o in opts]
        if 'duplicate' in opts:
            rxn.dup = True
        if 'negative_a' in opts or 'negative_orders' in opts:
            pass
        return 'skip' not in opts

    def reaction(self, equation, kf, ID='', options=None, order=None, **kw):
        rev, rs, rn, ps, pn, thd, pdep, pdep_sp = self._base(equation)
        if pdep or thd:
            raise MechanismError(
                'use three_body/falloff_reaction for: ' + equation)
        A = self._a(kf[0], sum(rn), 1.)
        rxn = Reaction(rev, rs, rn, ps, pn, A, kf[1], self._e(kf[2]))
        if self._apply_options(rxn, options):
            self.reactions.append(rxn)

    def three_body_reaction(self, equation, kf, efficiencies='', ID='',
                            options=None, **kw):
        rev, rs, rn, ps, pn, thd, pdep, pdep_sp = self._base(equation)
        A = self._a(kf[0], sum(rn), 0.)
        rxn = Reaction(rev, rs, rn, ps, pn, A, kf[1], self._e(kf[2]))
        rxn.thd_body = True
        rxn.thd_body_eff = self._effs(efficiencies)
        if self._apply_options(rxn, options):
            self.reactions.append(rxn)

    def falloff_reaction(self, equation, kf, kf0, efficiencies='',
                         falloff=None, ID='', options=None, **kw):
        rev, rs, rn, ps, pn, thd, pdep, pdep_sp = self._base(equation)
        A = self._a(kf[0], sum(rn), 1.)
        rxn = Reaction(rev, rs, rn, ps, pn, A, kf[1], self._e(kf[2]))
        rxn.pdep = True
        rxn.pdep_sp = pdep_sp
        rxn.low = [self._a(kf0[0], sum(rn), 0.), kf0[1], self._e(kf0[2])]
        rxn.thd_body_eff = self._effs(efficiencies)
        self._falloff(rxn, falloff)
        if self._apply_options(rxn, options):
            self.reactions.append(rxn)

    def chemically_activated_reaction(self, equation, kLow, kHigh,
                                      efficiencies='', falloff=None, ID='',
                                      options=None, **kw):
        rev, rs, rn, ps, pn, thd, pdep, pdep_sp = self._base(equation)
        A = self._a(kLow[0], sum(rn), 1.)
        rxn = Reaction(rev, rs, rn, ps, pn, A, kLow[1], self._e(kLow[2]))
        rxn.pdep = True
        rxn.pdep_sp = pdep_sp
        rxn.high = [self._a(kHigh[0], sum(rn), 2.), kHigh[1],
                    self._e(kHigh[2])]
        rxn.thd_body_eff = self._effs(efficiencies)
        self._falloff(rxn, falloff)
        if self._apply_options(rxn, options):
            self.reactions.append(rxn)

    def _falloff(self, rxn: Reaction, falloff) -> None:
        if falloff is None or falloff.kind == 'lindemann':
            return
        if falloff.kind == 'troe':
            rxn.troe = True
            par = list(falloff.par)
            # zero-parameter guard, matching the Chemkin path
            # (reference: mech_interpret.py:551-560)
            for i in (1, 2):
                if par[i] == 0:
                    par[i] = 1e-30
            rxn.troe_par = par
        elif falloff.kind == 'sri':
            rxn.sri = True
            rxn.sri_par = list(falloff.par)

    def pdep_arrhenius(self, equation, *rates, ID='', options=None, **kw):
        rev, rs, rn, ps, pn, thd, pdep, pdep_sp = self._base(equation)
        first = rates[0]
        rxn = Reaction(rev, rs, rn, ps, pn,
                       self._a(first[1], sum(rn), 1.), first[2],
                       self._e(first[3]))
        rxn.plog = True
        rxn.plog_par = []
        for rate in rates:
            P, A, b, E = rate
            rxn.plog_par.append([self._p(P), self._a(A, sum(rn), 1.), b,
                                 self._e(E)])
        rxn.plog_par.sort(key=lambda p: p[0])
        if self._apply_options(rxn, options):
            self.reactions.append(rxn)

    def chebyshev_reaction(self, equation, Tmin=300.0, Tmax=2500.0,
                           Pmin=(0.001, 'atm'), Pmax=(100.0, 'atm'),
                           coeffs=None, ID='', options=None, **kw):
        rev, rs, rn, ps, pn, thd, pdep, pdep_sp = self._base(equation)
        coeffs = np.asarray(coeffs, dtype=float)
        rxn = Reaction(rev, rs, rn, ps, pn, 0.0, 0.0, 0.0)
        rxn.cheb = True
        rxn.cheb_n_temp, rxn.cheb_n_pres = coeffs.shape
        rxn.cheb_tlim = [Tmin, Tmax]
        rxn.cheb_plim = [self._p(Pmin), self._p(Pmax)]
        par = np.array(coeffs, copy=True)
        # convert the constant term to kmol/m^3 units
        # (reference: mech_interpret.py:674-678)
        par[0, 0] += math.log10((1.0 / self.conc_fact) ** (sum(rn) - 1.))
        rxn.cheb_par = par
        if self._apply_options(rxn, options):
            self.reactions.append(rxn)


def read_mech_cti(path: str):
    """Parse a ``.cti`` mechanism file.

    Returns (elems, specs, reacs) in the same IR and internal units as
    :func:`pyjac_tpu.core.chemkin.read_mech`.
    """
    builder = _CtiBuilder()
    ns = {
        'units': builder.units,
        'ideal_gas': builder.ideal_gas,
        'state': builder.state,
        'species': builder.species,
        'NASA': builder.NASA,
        'gas_transport': builder.gas_transport,
        'reaction': builder.reaction,
        'three_body_reaction': builder.three_body_reaction,
        'falloff_reaction': builder.falloff_reaction,
        'chemically_activated_reaction':
            builder.chemically_activated_reaction,
        'pdep_arrhenius': builder.pdep_arrhenius,
        'chebyshev_reaction': builder.chebyshev_reaction,
        'Troe': _Troe,
        'SRI': _SRI,
        'OneAtm': PA,
        'stoichiometric_solid': lambda *a, **k: None,
        'ideal_interface': lambda *a, **k: None,
        '__builtins__': {},
    }
    with open(path, 'r') as f:
        code = f.read()
    exec(compile(code, path, 'exec'), ns)

    # order species by the phase declaration where available
    order = [s for s in builder.species_order if s in builder.species_map]
    for name in builder.species_map:
        if name not in order:
            order.append(name)
    specs = [builder.species_map[n] for n in order]

    reacs = builder.reactions
    # split explicit-reverse reactions: CTI has no REV card, nothing to do
    names = set(sp.name for sp in specs)
    for idx, rxn in enumerate(reacs):
        for sp in set(rxn.reac) | set(rxn.prod):
            if sp not in names:
                raise MechanismError(
                    'reaction {} contains unknown species {}'.format(idx, sp))
    return builder.elements, specs, reacs
