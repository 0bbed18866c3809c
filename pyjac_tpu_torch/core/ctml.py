"""Cantera CTML (legacy ``.xml``) mechanism reader.

The reference handles ``.xml`` through the Cantera library
(reference: pyjac/core/mech_interpret.py:886-1129 ``read_mech_ct``,
which accepts any ``ct.Solution``-loadable file); this module is a
self-contained stdlib ``xml.etree`` reader for the CTML documents
produced by Cantera's ``ctml_writer`` / ``ck2cti --output=xml``.

CTML numeric conventions (applied by ``ctml_writer`` at conversion
time, so the document itself is unit-normalized):

* pre-exponentials ``<A>`` are already in SI kmol/m^3 units — no
  molecularity-dependent conversion is needed (unlike ``.cti``/Chemkin
  input, which declares file-level units);
* activation energies ``<E units="...">`` carry an explicit units
  attribute (default J/kmol, Cantera's internal unit);
* pressures (``<P>``, ``<Pmin>``, ``<Pmax>``) carry units attributes
  (default Pa).

Output is the same IR and internal units as the other front ends
(activation temperature [K], kmol/m^3 pre-exponentials), so all four
formats (.inp/.dat, .cti, .yaml, .xml) pack identically.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from .chemkin import MechanismError, _split_falloff
from .constants import ACT_ENERGY_FACT, PA, get_elem_wt
from .ir import Reaction, Species

# energy-units attribute -> activation temperature [K] factor
_E_FACT = {
    'cal/mol': ACT_ENERGY_FACT['cal/mole'],
    'kcal/mol': ACT_ENERGY_FACT['kcal/mole'],
    'j/mol': ACT_ENERGY_FACT['joules/mole'],
    'kj/mol': ACT_ENERGY_FACT['kjoules/mole'],
    'j/kmol': ACT_ENERGY_FACT['joules/kmole'],
    'kj/kmol': ACT_ENERGY_FACT['joules/kmole'] * 1e3,
    'k': 1.0,
    'ev': ACT_ENERGY_FACT['evolts'],
}
_P_FACT = {'atm': PA, 'pa': 1.0, 'bar': 1e5, 'kpa': 1e3, 'mpa': 1e6,
           'torr': PA / 760.0}


def _floats(text: str) -> List[float]:
    return [float(t) for t in (text or '').replace(',', ' ').split()]


def _energy(node: Optional[ET.Element]) -> float:
    """``<E units="cal/mol">0.0</E>`` -> activation temperature [K]."""
    if node is None:
        return 0.0
    unit = (node.get('units') or 'J/kmol').lower()
    try:
        fact = _E_FACT[unit]
    except KeyError:
        raise MechanismError('unknown energy units %r' % unit)
    return float(node.text) * fact


def _pressure(node: Optional[ET.Element], default: float = 0.0) -> float:
    if node is None:
        return default
    unit = (node.get('units') or 'pa').lower()
    try:
        fact = _P_FACT[unit]
    except KeyError:
        raise MechanismError('unknown pressure units %r' % unit)
    return float(node.text) * fact


def _arrhenius(node: ET.Element) -> Tuple[float, float, float]:
    """(A [SI kmol/m^3], b, E [K]) from an ``<Arrhenius>`` element."""
    A = float(node.findtext('A', '0'))
    b = float(node.findtext('b', '0'))
    return A, b, _energy(node.find('E'))


def _side(node: Optional[ET.Element]) -> Tuple[List[str], List[float]]:
    """``<reactants>O:2.0 H2:1</reactants>`` -> (names, coeffs)."""
    sp, nu = [], []
    for pair in (node.text or '').split() if node is not None else []:
        name, coeff = pair.rsplit(':', 1)
        sp.append(name)
        nu.append(float(coeff))
    return sp, nu


def _species(node: ET.Element, elem_wt) -> Species:
    sp = Species(node.get('name'))
    for pair in (node.findtext('atomArray') or '').split():
        el, num = pair.rsplit(':', 1)
        n = int(float(num))
        if n == 0:
            continue
        sp.elem.append([el, n])
        sp.mw += n * elem_wt[el.lower()]
    polys = []
    for nasa in node.findall('./thermo/NASA'):
        arr = nasa.find('floatArray')
        coeffs = _floats(arr.text if arr is not None else '')
        if len(coeffs) != 7:
            raise MechanismError(
                'species %s: NASA7 block needs 7 coefficients, got %d'
                % (sp.name, len(coeffs)))
        polys.append((float(nasa.get('Tmin')), float(nasa.get('Tmax')),
                      coeffs))
    if not polys:
        raise MechanismError('species %s missing NASA thermo' % sp.name)
    polys.sort(key=lambda p: p[0])
    if len(polys) == 1:
        tlo, thi, c = polys[0]
        sp.lo = np.asarray(c, dtype=float)
        sp.hi = np.asarray(c, dtype=float)
        sp.Trange = [tlo, thi, thi]
    else:
        sp.lo = np.asarray(polys[0][2], dtype=float)
        sp.hi = np.asarray(polys[1][2], dtype=float)
        sp.Trange = [polys[0][0], polys[0][1], polys[1][1]]
    return sp


def _efficiencies(rxn: Reaction, node: Optional[ET.Element],
                  all_names: List[str]) -> None:
    if node is None:
        return
    explicit = {}
    for pair in (node.text or '').split():
        name, val = pair.rsplit(':', 1)
        explicit[name] = float(val)
    default = float(node.get('default', '1.0'))
    if default == 1.0:
        rxn.thd_body_eff = [[n, v] for n, v in explicit.items()]
    else:
        # a non-unit default applies to every unlisted species
        rxn.thd_body_eff = [[n, explicit.get(n, default)]
                            for n in all_names]


def _falloff(rxn: Reaction, node: Optional[ET.Element]) -> None:
    if node is None:
        return
    kind = (node.get('type') or 'Lindemann').lower()
    par = _floats(node.text)
    if kind == 'lindemann':
        return
    if kind == 'troe':
        if len(par) not in (3, 4):
            raise MechanismError('Troe falloff needs 3 or 4 parameters')
        # zero-parameter guard, matching the Chemkin path
        # (reference: mech_interpret.py:551-560)
        for i in (1, 2):
            if par[i] == 0:
                par[i] = 1e-30
        rxn.troe = True
        rxn.troe_par = par
    elif kind == 'sri':
        if len(par) not in (3, 5):
            raise MechanismError('SRI falloff needs 3 or 5 parameters')
        rxn.sri = True
        rxn.sri_par = par
    else:
        raise MechanismError('unsupported falloff type %r' % kind)


def _equation_pdep(equation: str) -> Tuple[bool, bool, Optional[str]]:
    """(third-body?, pressure-dependent?, pdep collider) from the
    CTML equation string ('2 O + M [=] O2 + M', 'H + O2 (+ M) ...')."""
    eq = equation.replace('[=]', '<=>').replace('=]', '=>')
    lhs = eq.split('<=>')[0].split('=>')[0]
    lhs, pdep, pdep_sp = _split_falloff(lhs.strip())
    tokens = [t.strip() for t in lhs.split('+')]
    thd = 'M' in tokens or 'm' in tokens
    return thd and not pdep, pdep, pdep_sp


def _reaction(node: ET.Element, all_names: List[str]) -> Optional[Reaction]:
    rtype = (node.get('type') or 'elementary').lower()
    rev = (node.get('reversible') or 'yes').lower() in ('yes', 'true')
    rs, rn = _side(node.find('reactants'))
    ps, pn = _side(node.find('products'))
    if not rs or not ps:
        raise MechanismError('reaction %s missing reactants/products'
                             % node.get('id', '?'))
    thd, pdep, pdep_sp = _equation_pdep(node.findtext('equation') or '')

    rc = node.find('rateCoeff')
    if rc is None:
        raise MechanismError('reaction %s missing rateCoeff'
                             % node.get('id', '?'))
    arrs = rc.findall('Arrhenius')
    named = {a.get('name'): a for a in arrs if a.get('name')}
    plain = [a for a in arrs if not a.get('name')]

    rxn = Reaction(rev, rs, rn, ps, pn, 1.0, 0.0, 0.0)
    rxn.dup = (node.get('duplicate') or 'no').lower() in ('yes', 'true')

    if rtype in ('elementary', 'arrhenius', 'threebody', 'three-body'):
        rxn.A, rxn.b, rxn.E = _arrhenius(plain[0])
        rxn.thd_body = thd or rtype in ('threebody', 'three-body')
        if rxn.thd_body:
            _efficiencies(rxn, rc.find('efficiencies'), all_names)
    elif rtype == 'falloff':
        if 'k0' not in named:
            raise MechanismError('falloff reaction missing k0 Arrhenius')
        rxn.pdep = True
        rxn.pdep_sp = pdep_sp
        rxn.A, rxn.b, rxn.E = _arrhenius(plain[0])
        rxn.low = list(_arrhenius(named['k0']))
        _efficiencies(rxn, rc.find('efficiencies'), all_names)
        _falloff(rxn, rc.find('falloff'))
    elif rtype in ('chemact', 'chemically-activated'):
        if 'kHigh' not in named:
            raise MechanismError(
                'chemically-activated reaction missing kHigh Arrhenius')
        rxn.pdep = True
        rxn.pdep_sp = pdep_sp
        rxn.A, rxn.b, rxn.E = _arrhenius(plain[0])
        rxn.high = list(_arrhenius(named['kHigh']))
        _efficiencies(rxn, rc.find('efficiencies'), all_names)
        _falloff(rxn, rc.find('falloff'))
    elif rtype in ('plog', 'pressure-dependent-arrhenius'):
        rxn.plog = True
        rxn.plog_par = []
        for a in arrs:
            A, b, E = _arrhenius(a)
            rxn.plog_par.append([_pressure(a.find('P'), PA), A, b, E])
        rxn.plog_par.sort(key=lambda p: p[0])
        rxn.A, rxn.b, rxn.E = rxn.plog_par[0][1:]
    elif rtype == 'chebyshev':
        rxn.cheb = True
        arr = rc.find('floatArray')
        nT = int(arr.get('degreeT'))
        nP = int(arr.get('degreeP'))
        rxn.cheb_n_temp, rxn.cheb_n_pres = nT, nP
        rxn.cheb_par = np.asarray(_floats(arr.text),
                                  dtype=float).reshape(nT, nP)
        rxn.cheb_tlim = [float(rc.findtext('Tmin', '300')),
                         float(rc.findtext('Tmax', '2500'))]
        rxn.cheb_plim = [_pressure(rc.find('Pmin'), 1e-3 * PA),
                         _pressure(rc.find('Pmax'), 100.0 * PA)]
        rxn.A, rxn.b, rxn.E = 1.0, 0.0, 0.0
    else:
        raise MechanismError('unsupported reaction type %r' % rtype)
    return rxn


def read_mech_ctml(path: str, phase: Optional[str] = None):
    """Parse a Cantera CTML ``.xml`` mechanism.

    Returns (elems, specs, reacs) in the same IR and internal units as
    :func:`pyjac_tpu.core.chemkin.read_mech`.
    """
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError as e:
        raise MechanismError('cannot parse CTML %s: %s' % (path, e))
    if root.tag != 'ctml':
        raise MechanismError('%s is not a CTML document (root <%s>)'
                             % (path, root.tag))

    phases = root.findall('phase')
    ph = None
    if phases:
        ph = phases[0]
        if phase is not None:
            ph = next((p for p in phases if p.get('id') == phase), ph)
    elems = (ph.findtext('elementArray') or '').split() if ph is not None \
        else []
    order = (ph.findtext('speciesArray') or '').split() if ph is not None \
        else []

    elem_wt = get_elem_wt()
    specs_map: Dict[str, Species] = {}
    for snode in root.findall('./speciesData/species'):
        sp = _species(snode, elem_wt)
        specs_map[sp.name] = sp

    names = [n for n in order if n in specs_map] or list(specs_map)
    for n in specs_map:
        if n not in names:
            names.append(n)
    specs = [specs_map[n] for n in names]

    reacs: List[Reaction] = []
    for rnode in root.findall('./reactionData/reaction'):
        rxn = _reaction(rnode, names)
        if rxn is not None:
            reacs.append(rxn)

    names_set = set(names)
    for idx, rxn in enumerate(reacs):
        for sp in set(rxn.reac) | set(rxn.prod):
            if sp not in names_set:
                raise MechanismError(
                    'reaction %d contains unknown species %s' % (idx, sp))
    return elems, specs, reacs
