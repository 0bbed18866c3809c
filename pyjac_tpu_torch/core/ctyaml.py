"""Cantera YAML mechanism reader (modern Cantera >= 2.5 format).

The reference predates the YAML format entirely (it handles `.cti`/
`.xml` through the Cantera library, mech_interpret.py:886-1129); modern
mechanism distributions are YAML-first, so this self-contained reader
extends the front end beyond the reference's coverage. Supported:
``units``, ``phases`` (species ordering), NASA7 species thermo, and
reaction types elementary / three-body / falloff (Lindemann, Troe, SRI)
/ chemically-activated / pressure-dependent-Arrhenius (PLOG) /
Chebyshev, with duplicate flags and efficiencies. Output is the same IR
and internal units as the Chemkin parser (activation temperature [K],
kmol/m^3 pre-exponentials).
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

import numpy as np

from .chemkin import MechanismError, _parse_side, _split_falloff
from .constants import PA, RU_JOUL, get_elem_wt
from .ir import Reaction, Species

# energy-unit name -> activation temperature factor [K per unit/mol-ish]
_E_FACT = {
    'cal/mol': 4.184 / RU_JOUL,
    'kcal/mol': 4184.0 / RU_JOUL,
    'j/mol': 1.0 / RU_JOUL,
    'kj/mol': 1000.0 / RU_JOUL,
    'j/kmol': 1.0 / (RU_JOUL * 1000.0),
    'k': 1.0,
    'ev': 11595.0,
}
_LEN_EXP = {'m': 0, 'cm': -2, 'mm': -3}
_QTY_EXP = {'kmol': 0, 'mol': -3}
_P_FACT = {'atm': PA, 'pa': 1.0, 'bar': 1e5, 'kpa': 1e3, 'mpa': 1e6,
           'dyn/cm^2': 0.1, 'torr': PA / 760.0}

_NUM_UNIT = re.compile(r'^\s*([-+0-9.eE]+)\s*(.*)$')


def _parse_quantity(val, fact_table, default_unit=None):
    """'0.1 atm' / 101325.0 / {'A': ...} -> SI float."""
    if isinstance(val, (int, float)):
        if default_unit is None:
            return float(val)
        return float(val) * fact_table[default_unit]
    m = _NUM_UNIT.match(str(val))
    if not m:
        raise MechanismError('cannot parse quantity %r' % (val,))
    num = float(m.group(1))
    unit = m.group(2).strip().lower()
    if not unit:
        unit = default_unit
    return num * fact_table[unit]


class _Units:
    def __init__(self, spec: Optional[dict]):
        spec = spec or {}
        self.act = str(spec.get('activation-energy', 'cal/mol')).lower()
        length = str(spec.get('length', 'm')).lower()
        qty = str(spec.get('quantity', 'kmol')).lower()
        # conc factor as exact power of ten: 1 qty/length^3 in kmol/m^3
        self.conc_fact = 10.0 ** (_QTY_EXP[qty] - 3 * _LEN_EXP[length])

    def energy(self, val) -> float:
        """activation energy -> activation temperature [K]."""
        if isinstance(val, (int, float)):
            return float(val) * _E_FACT[self.act]
        m = _NUM_UNIT.match(str(val))
        num = float(m.group(1))
        unit = m.group(2).strip().lower() or self.act
        return num * _E_FACT[unit]

    def pre_exp(self, val, order: float, offset: float) -> float:
        """A -> kmol/m^3 units; molecularity = order - offset + 1."""
        if not isinstance(val, (int, float)):
            m = _NUM_UNIT.match(str(val))
            val = float(m.group(1))   # unit string ignored: assumed
            # consistent with the file-level units block
        expo = order - offset
        if expo == 0:
            return float(val)
        if expo > 0:
            return float(val) / self.conc_fact ** expo
        return float(val) * self.conc_fact ** (-expo)


def _arrhenius(node, units: _Units, order: float, offset: float):
    A = units.pre_exp(node['A'], order, offset)
    b = float(node.get('b', 0.0))
    E = units.energy(node.get('Ea', 0.0))
    return A, b, E


def read_mech_yaml(path: str, phase: Optional[str] = None):
    """Parse a Cantera YAML mechanism -> (elems, specs, reacs)."""
    import yaml
    with open(path) as fh:
        doc = yaml.safe_load(fh)

    units = _Units(doc.get('units'))
    elem_wt = get_elem_wt()

    phases = doc.get('phases', [])
    ph = None
    if phases:
        ph = phases[0]
        if phase is not None:
            ph = next((p for p in phases if p.get('name') == phase), ph)
    elems = list(ph.get('elements', [])) if ph else []
    order = list(ph.get('species', [])) if ph else []
    if order and isinstance(order[0], dict):
        # external species sections not supported; flatten local names
        order = [s for d in order for s in (d.get(list(d)[0]) or [])]

    specs_map: Dict[str, Species] = {}
    for snode in doc.get('species', []):
        sp = Species(snode['name'])
        for el, n in (snode.get('composition') or {}).items():
            n = int(float(n))
            if n == 0:
                continue
            sp.elem.append([el, n])
            sp.mw += n * elem_wt[el.lower()]
        th = snode.get('thermo') or {}
        if str(th.get('model', '')).upper() != 'NASA7':
            raise MechanismError(
                'species %s: only NASA7 thermo supported, got %r'
                % (sp.name, th.get('model')))
        ranges = th['temperature-ranges']
        data = th['data']
        if len(data) == 1:
            sp.lo = np.asarray(data[0], dtype=float)
            sp.hi = np.asarray(data[0], dtype=float)
            sp.Trange = [ranges[0], ranges[-1], ranges[-1]]
        else:
            sp.lo = np.asarray(data[0], dtype=float)
            sp.hi = np.asarray(data[1], dtype=float)
            sp.Trange = [ranges[0], ranges[1], ranges[2]]
        specs_map[sp.name] = sp

    names = [n for n in order if n in specs_map] or list(specs_map)
    for n in specs_map:
        if n not in names:
            names.append(n)
    specs = [specs_map[n] for n in names]

    reacs: List[Reaction] = []
    for rnode in doc.get('reactions', []):
        eq = rnode['equation']
        if '<=>' in eq:
            lhs, rhs = eq.split('<=>', 1)
            rev = True
        elif '=>' in eq:
            lhs, rhs = eq.split('=>', 1)
            rev = False
        else:
            lhs, rhs = eq.split('=', 1)
            rev = True
        lhs, pdep_l, sp_l = _split_falloff(lhs.strip())
        rhs, pdep_r, sp_r = _split_falloff(rhs.strip())
        pdep = pdep_l or pdep_r
        pdep_sp = sp_l or sp_r
        rs, rn, thd_l = _parse_side(lhs)
        ps, pn, thd_r = _parse_side(rhs)
        thd = (thd_l or thd_r) and not pdep
        order_f = sum(rn)

        rtype = str(rnode.get('type', 'elementary')).lower()
        rxn = Reaction(rev, rs, rn, ps, pn, 1.0, 0.0, 0.0)
        rxn.dup = bool(rnode.get('duplicate', False))

        if rtype in ('elementary', 'reaction', 'three-body'):
            off = 0.0 if (thd or rtype == 'three-body') else 1.0
            rxn.A, rxn.b, rxn.E = _arrhenius(rnode['rate-constant'],
                                             units, order_f, off)
            rxn.thd_body = thd or (rtype == 'three-body' and not pdep)
        elif rtype == 'falloff':
            rxn.pdep = True
            rxn.pdep_sp = pdep_sp
            rxn.A, rxn.b, rxn.E = _arrhenius(
                rnode['high-P-rate-constant'], units, order_f, 1.0)
            rxn.low = list(_arrhenius(rnode['low-P-rate-constant'],
                                      units, order_f, 0.0))
            _yaml_falloff(rxn, rnode)
        elif rtype == 'chemically-activated':
            rxn.pdep = True
            rxn.pdep_sp = pdep_sp
            rxn.A, rxn.b, rxn.E = _arrhenius(
                rnode['low-P-rate-constant'], units, order_f, 1.0)
            rxn.high = list(_arrhenius(rnode['high-P-rate-constant'],
                                       units, order_f, 2.0))
            _yaml_falloff(rxn, rnode)
        elif rtype == 'pressure-dependent-arrhenius':
            rxn.plog = True
            rxn.plog_par = []
            for entry in rnode['rate-constants']:
                P = _parse_quantity(entry['P'], _P_FACT, 'atm')
                A, b, E = _arrhenius(entry, units, order_f, 1.0)
                rxn.plog_par.append([P, A, b, E])
            rxn.plog_par.sort(key=lambda p: p[0])
            rxn.A, rxn.b, rxn.E = rxn.plog_par[0][1:]
        elif rtype == 'chebyshev':
            rxn.cheb = True
            coeffs = np.asarray(rnode['data'], dtype=float)
            rxn.cheb_n_temp, rxn.cheb_n_pres = coeffs.shape
            tr = rnode['temperature-range']
            pr = rnode['pressure-range']
            rxn.cheb_tlim = [_parse_quantity(tr[0], {'k': 1.0}, 'k'),
                             _parse_quantity(tr[1], {'k': 1.0}, 'k')]
            rxn.cheb_plim = [_parse_quantity(pr[0], _P_FACT, 'atm'),
                             _parse_quantity(pr[1], _P_FACT, 'atm')]
            par = np.array(coeffs, copy=True)
            par[0, 0] += math.log10(
                (1.0 / units.conc_fact) ** (order_f - 1.0))
            rxn.cheb_par = par
            rxn.A, rxn.b, rxn.E = 1.0, 0.0, 0.0
        else:
            raise MechanismError('unsupported reaction type %r' % rtype)

        for sp, eff in (rnode.get('efficiencies') or {}).items():
            rxn.thd_body_eff.append([sp, float(eff)])
        reacs.append(rxn)

    names_set = set(names)
    for idx, rxn in enumerate(reacs):
        for sp in set(rxn.reac) | set(rxn.prod):
            if sp not in names_set:
                raise MechanismError(
                    'reaction %d contains unknown species %s' % (idx, sp))
    return elems, specs, reacs


def _yaml_falloff(rxn: Reaction, rnode: dict) -> None:
    tr = rnode.get('Troe')
    if tr:
        rxn.troe = True
        par = [float(tr['A']), float(tr['T3']), float(tr['T1'])]
        for i in (1, 2):
            if par[i] == 0:
                par[i] = 1e-30
        if 'T2' in tr:
            par.append(float(tr['T2']))
        rxn.troe_par = par
        return
    sr = rnode.get('SRI')
    if sr:
        rxn.sri = True
        par = [float(sr['A']), float(sr['B']), float(sr['C'])]
        if 'D' in sr or 'E' in sr:
            par.append(float(sr.get('D', 1.0)))
            par.append(float(sr.get('E', 0.0)))
        rxn.sri_par = par
