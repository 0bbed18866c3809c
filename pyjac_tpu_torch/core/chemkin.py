"""Self-contained Chemkin-format mechanism and NASA-7 thermo parser.

Behavioral parity with the reference interpreter
(reference: pyjac/core/mech_interpret.py:56-883) without requiring
Cantera:

* ELEMENTS / SPECIES / REACTIONS / THERMO sections,
* reaction equations with ``<=>``, ``=>``, ``=``, stoichiometric
  coefficients, third bodies (``+M``) and falloff markers ``(+M)`` /
  ``(+SP)``,
* auxiliary cards: DUP, REV, LOW, HIGH, TROE, SRI, CHEB / PCHEB / TCHEB,
  PLOG, and enhanced third-body efficiencies,
* unit conversion of activation energies to activation temperatures [K]
  and of pre-exponential factors from mol/cm^3 to kmol/m^3 units,
* splitting of reversible reactions with explicit REV parameters into two
  irreversible reactions (reference: mech_interpret.py:693-713),
* the Troe zero-parameter guard (-> 1e-30,
  reference: mech_interpret.py:551-560),
* Chebyshev coefficient validation, unit fix and reshape
  (reference: mech_interpret.py:664-680).
"""

from __future__ import annotations

import logging
import math
import re
from typing import List, Optional, Tuple

import numpy as np

from .constants import ACT_ENERGY_FACT, PA, get_elem_wt
from .ir import Reaction, Species

log = logging.getLogger(__name__)


class MechanismError(ValueError):
    """Raised on malformed or inconsistent mechanism input."""


def _strip_comment(line: str) -> str:
    ind = line.find('!')
    if ind >= 0:
        line = line[:ind]
    return line.strip()


def _parse_coefficient(token: str) -> Tuple[float, str]:
    """Split a leading stoichiometric coefficient off a species token.

    ``'2H2O'`` -> (2, 'H2O'); ``'0.5O2'`` -> (0.5, 'O2'); ``'OH'`` -> (1, 'OH').
    Integer coefficients stay integers so downstream code can use exact
    multiplication (reference: mech_interpret.py:300-318).
    """
    m = re.match(r'^(\d+\.?\d*|\.\d+)', token)
    if not m:
        return 1, token
    num = m.group(0)
    rest = token[len(num):].strip()
    if not rest:
        # token was purely numeric -> no species name; treat as name
        return 1, token
    if '.' in num:
        return float(num), rest
    return int(num), rest


def _split_falloff(side: str) -> Tuple[str, bool, str]:
    """Extract a ``(+M)`` / ``(+SP)`` falloff marker from one side of an
    equation.

    Returns (side_without_marker, pdep_found, pdep_species) where
    pdep_species is '' for the mixture (``M``). Parenthesized fragments
    that are part of species names (no leading '+') are left alone
    (reference: mech_interpret.py:239-272).
    """
    sub = side
    offset = 0
    while '(' in sub:
        i1 = sub.find('(')
        i2 = sub.find(')', i1)
        if i2 < 0:
            break
        inner = sub[i1 + 1:i2].strip()
        if inner == '+':
            # '(+)' embedded in a species name
            offset += i2 + 1
            sub = sub[i2 + 1:]
        elif inner.startswith('+'):
            sp = inner[1:].replace('+', ' ').strip()
            cleaned = side[:offset + i1] + side[offset + i2 + 1:]
            if sp.lower() == 'm':
                return cleaned, True, ''
            return cleaned, True, sp
        else:
            offset += i2 + 1
            sub = sub[i2 + 1:]
    return side, False, ''


def _parse_side(side: str):
    """Parse one side of a reaction equation into (species, nu, third_body).

    Handles species names ending in '+' (ions) and names containing
    '(+)' that the '+' split tears apart
    (reference: mech_interpret.py:274-333).
    """
    parts = side.split('+')
    # re-join empty fragments: 'A++B' means species name 'A+'
    merged: List[str] = []
    for p in parts:
        if p == '' and merged:
            merged[-1] = merged[-1] + '+'
        else:
            merged.append(p)
    # re-join '(' ... ')' splits from species names containing '(+)'
    i = 0
    while i < len(merged) - 1:
        if merged[i].rstrip().endswith('(') and merged[i + 1].lstrip().startswith(')'):
            merged[i] = merged[i] + '+' + merged[i + 1]
            del merged[i + 1]
        else:
            i += 1

    species: List[str] = []
    nus: List[float] = []
    third_body = False
    for token in merged:
        token = token.strip()
        if not token:
            continue
        nu, name = _parse_coefficient(token)
        if name.lower() == 'm':
            third_body = True
            continue
        if name in species:
            i = species.index(name)
            nus[i] += nu
        else:
            species.append(name)
            nus.append(nu)
    return species, nus, third_body


def _convert_A(A: float, order: float, offset: float) -> float:
    """Convert pre-exponential from mol/cm^3-based to kmol/m^3-based units.

    ``A / 1000**(order - offset)`` — the reference applies offset 0 for
    third-body and LOW (one extra concentration), 1 for elementary /
    falloff-high-limit / PLOG, 2 for chemically-activated HIGH cards
    (reference: mech_interpret.py:441-452, 515-517, 534-536, 649-652).
    """
    return A / 1000. ** (order - offset)


def read_mech(mech_path: str, therm_path: Optional[str] = None):
    """Parse a Chemkin mechanism (and optional thermo database).

    Returns (elems, specs, reacs) with fully resolved thermo data; E is
    converted to activation temperature [K] and A to kmol/m^3 units.
    Reference: pyjac/core/mech_interpret.py:56-732.
    """
    elems: List[str] = []
    specs: List[Species] = []
    reacs: List[Reaction] = []
    elem_wt = get_elem_wt()

    units_E = 'cal/mole'
    units_A = 'moles'
    key = ''
    cheb_started = False

    with open(mech_path, 'r') as f:
        lines = f.readlines()

    for raw in lines:
        if re.search(r'^\s*$', raw) or re.search(r'^\s*!', raw):
            continue
        line = _strip_comment(raw)
        if not line:
            continue

        head = line[0:4].lower()
        if head == 'elem':
            key = 'elem'
            parts = line.split()
            if len(parts) > 1:
                line = line[line.index(parts[1]):]
            else:
                continue
        elif head == 'spec':
            key = 'spec'
            parts = line.split()
            if len(parts) > 1:
                line = line[line.index(parts[1]):]
            else:
                continue
        elif head == 'reac':
            key = 'reac'
            units_E = 'cal/mole'
            units_A = 'moles'
            for unit in line.split()[1:]:
                u = unit.lower()
                if u in ('moles', 'molecules'):
                    units_A = u
                elif u in ACT_ENERGY_FACT:
                    units_E = u
                else:
                    raise MechanismError(
                        'unsupported units on REACTION line: ' + unit)
            if units_A == 'molecules':
                raise NotImplementedError('molecules units not supported')
            continue
        elif head == 'ther':
            read_thermo(mech_path, elems, specs, elem_wt)
            continue
        elif line[0:3].lower() == 'end':
            key = ''
            continue

        if key == 'elem':
            line = line.replace('/', ' ')
            e_last = ''
            for tok in line.split():
                if tok.isalpha():
                    if tok[0:3].lower() == 'end':
                        continue
                    if tok not in elems:
                        elems.append(tok)
                    e_last = tok
                else:
                    # explicit atomic weight declaration
                    elem_wt[e_last.lower()] = float(tok)

        elif key == 'spec':
            for tok in line.split():
                if tok[0:3].lower() == 'end':
                    continue
                if not any(sp.name == tok for sp in specs):
                    specs.append(Species(tok))

        elif key == 'reac':
            if '=' in line:
                cheb_started = False
                parts = line.split()
                try:
                    A = float(parts[-3])
                    b = float(parts[-2])
                    E = float(parts[-1])
                except (ValueError, IndexError):
                    raise MechanismError('bad reaction line: ' + line)
                # strip the three Arrhenius tokens from the right
                eq = line
                for _ in range(3):
                    eq = eq[:eq.rindex(eq.split()[-1])].rstrip()

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

                E = E * ACT_ENERGY_FACT[units_E]
                order = sum(reac_nu)
                if units_A == 'moles':
                    if thd:
                        A = _convert_A(A, order, 0.)
                    else:
                        # elementary, falloff high-limit, or chem-activated
                        # low-limit parameters all sit at order-1
                        A = _convert_A(A, order, 1.)

                rxn = Reaction(rev, reac_sp, reac_nu, prod_sp, prod_nu,
                               A, b, E)
                rxn.thd_body = thd
                rxn.pdep = pdep
                if pdep:
                    rxn.pdep_sp = pdep_sp
                reacs.append(rxn)
            else:
                if not reacs:
                    raise MechanismError('auxiliary line before any '
                                         'reaction: ' + line)
                rxn = reacs[-1]
                aux = line[0:3].lower()
                data = line.replace('/', ' ').replace(',', ' ').split()
                if aux == 'dup':
                    rxn.dup = True
                elif aux == 'rev':
                    p = [float(x) for x in data[1:4]]
                    p[2] *= ACT_ENERGY_FACT[units_E]
                    if units_A == 'moles':
                        order = sum(rxn.prod_nu)
                        if rxn.thd_body:
                            p[0] = _convert_A(p[0], order, 0.)
                        else:
                            p[0] = _convert_A(p[0], order, 1.)
                    if p[0] != 0.0:
                        rxn.rev_par = p
                    else:
                        rxn.rev = False
                elif aux == 'low':
                    p = [float(x) for x in data[1:4]]
                    p[2] *= ACT_ENERGY_FACT[units_E]
                    if units_A == 'moles':
                        p[0] = _convert_A(p[0], sum(rxn.reac_nu), 0.)
                    rxn.low = p
                elif aux == 'hig':
                    p = [float(x) for x in data[1:4]]
                    p[2] *= ACT_ENERGY_FACT[units_E]
                    if units_A == 'moles':
                        p[0] = _convert_A(p[0], sum(rxn.reac_nu), 2.)
                    rxn.high = p
                elif aux == 'tro':
                    rxn.troe = True
                    p = [float(x) for x in data[1:4]]
                    # avoid division by zero in the falloff blend
                    # (reference: mech_interpret.py:551-560)
                    for i in (1, 2):
                        if p[i] == 0:
                            log.warning(
                                'Troe parameter in reaction %d modified '
                                'to avoid division by zero', len(reacs))
                            p[i] = 1e-30
                    if len(data) > 4:
                        p.append(float(data[4]))
                    rxn.troe_par = p
                elif aux == 'sri':
                    rxn.sri = True
                    p = [float(x) for x in data[1:4]]
                    if len(data) > 4:
                        p.append(float(data[4]))
                        p.append(float(data[5]))
                    rxn.sri_par = p
                elif aux == 'che':
                    if cheb_started and rxn.cheb:
                        rxn.cheb_par.extend(float(x) for x in data[1:])
                    else:
                        cheb_started = True
                        rxn.cheb = True
                        rxn.pdep = False
                        rxn.cheb_n_temp = int(float(data[1]))
                        rxn.cheb_n_pres = int(float(data[2]))
                        rxn.cheb_par = [float(x) for x in data[3:]]
                elif aux == 'pch':
                    rxn.cheb_plim = [float(data[1]) * PA, float(data[2]) * PA]
                    if len(data) > 3 and data[3].lower() == 'tcheb':
                        rxn.cheb_tlim = [float(data[4]), float(data[5])]
                elif aux == 'tch':
                    rxn.cheb_tlim = [float(data[1]), float(data[2])]
                    if len(data) > 3 and data[3].lower() == 'pcheb':
                        rxn.cheb_plim = [float(data[4]) * PA,
                                         float(data[5]) * PA]
                elif aux == 'plo':
                    if not rxn.plog:
                        rxn.plog = True
                        rxn.pdep = False
                        rxn.plog_par = []
                    p = [float(x) for x in data[1:5]]
                    p[0] *= PA
                    p[3] *= ACT_ENERGY_FACT[units_E]
                    if units_A == 'moles':
                        p[1] = _convert_A(p[1], sum(rxn.reac_nu), 1.)
                    rxn.plog_par.append(p)
                else:
                    # enhanced third-body efficiency pairs
                    for i in range(0, len(data), 2):
                        rxn.thd_body_eff.append(
                            [data[i], float(data[i + 1])])

    _finalize_reactions(reacs, specs, units_A)

    # read separate thermo database if species data still missing
    if any(sp.mw == 0.0 for sp in specs):
        if therm_path:
            read_thermo(therm_path, elems, specs, elem_wt)
        else:
            missing = [sp.name for sp in specs if sp.mw == 0.0]
            raise MechanismError(
                'missing thermo data and no thermo file given for: ' +
                ', '.join(missing))
    missing = [sp.name for sp in specs if sp.mw == 0.0]
    if missing:
        raise MechanismError('missing thermo data for: ' + ', '.join(missing))

    return elems, specs, reacs


def _finalize_reactions(reacs: List[Reaction], specs: List[Species],
                        units_A: str) -> None:
    # Chebyshev: validate coefficient count, apply unit conversion to the
    # constant term, reshape to (n_temp, n_pres)
    # (reference: mech_interpret.py:664-680)
    for idx, rxn in enumerate(reacs):
        if rxn.cheb:
            n, m = rxn.cheb_n_temp, rxn.cheb_n_pres
            if len(rxn.cheb_par) != n * m:
                raise MechanismError(
                    'wrong number of CHEB coefficients in reaction '
                    '{}: got {}, expected {}'.format(idx, len(rxn.cheb_par),
                                                     n * m))
            order = sum(rxn.reac_nu)
            par = list(rxn.cheb_par)
            if units_A == 'moles':
                par[0] += math.log10(0.001 ** (order - 1.))
            rxn.cheb_par = np.reshape(np.asarray(par), (n, m))

    # unknown-species check (reference: mech_interpret.py:682-691)
    names = set(sp.name for sp in specs)
    for idx, rxn in enumerate(reacs):
        for sp in set(rxn.reac) | set(rxn.prod):
            if sp not in names:
                raise MechanismError(
                    'reaction {} contains unknown species {}'.format(idx, sp))

    # split reversible reactions with explicit REV parameters into two
    # irreversible reactions (reference: mech_interpret.py:693-713)
    i = 0
    while i < len(reacs):
        rxn = reacs[i]
        if rxn.rev_par:
            new = rxn.copy()
            rxn.rev = False
            rev_par = rxn.rev_par
            rxn.rev_par = []
            new.A, new.b, new.E = rev_par
            new.rev = False
            new.rev_par = []
            new.reac, new.prod = list(rxn.prod), list(rxn.reac)
            new.reac_nu, new.prod_nu = list(rxn.prod_nu), list(rxn.reac_nu)
            reacs.insert(i + 1, new)
            i += 1
        i += 1


def _split_fixed(s: str, n: int) -> List[str]:
    return [s[i:i + n] for i in range(0, len(s), n)]


def read_thermo(path: str, elems: List[str], specs: List[Species],
                elem_wt: Optional[dict] = None) -> None:
    """Read a NASA-7 thermodynamic database, filling in species data.

    Fixed-column Chemkin THERMO format
    (reference: pyjac/core/mech_interpret.py:735-883).
    """
    if elem_wt is None:
        elem_wt = get_elem_wt()

    with open(path, 'r') as f:
        lines = f.readlines()

    # skip to the THERMO header
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if re.search(r'^\s*$', line) or re.search(r'^\s*!', line):
            continue
        if 'thermo' in line.lower():
            break

    # optional common temperature-range line
    T_ranges = [300.0, 1000.0, 5000.0]
    j = i
    while j < len(lines):
        line = lines[j]
        if re.search(r'^\s*$', line) or re.search(r'^\s*!', line):
            j += 1
            continue
        parts = line.split()
        if parts and parts[0][0:1].isdigit():
            T_ranges = [float(p) for p in parts[:3]]
            i = j + 1
        break

    while i < len(lines):
        line = lines[i]
        if re.search(r'^\s*$', line) or re.search(r'^\s*!', line):
            i += 1
            continue
        if line[0:3].lower() == 'end':
            break

        name = line[0:18].strip()
        if name.find(' ') > 0:
            name = name[:name.find(' ')]

        sp = next((s for s in specs if s.name == name), None)
        if sp is None or sp.mw:
            i += 4
            continue

        # elemental composition, columns 24:44 in 5-char chunks
        for e_str in _split_fixed(line[24:44], 5):
            e = e_str[0:2].strip()
            if e in ('', '0'):
                continue
            num = e_str[2:].strip()
            if not num:
                continue
            e_num = int(float(num))
            if e_num == 0:
                continue
            sp.elem.append([e, e_num])
            sp.mw += e_num * elem_wt[e.lower()]

        # temperature ranges, columns 45:74
        T_spec = [float(x) for x in line[45:74].split()]
        T_low, T_high = T_spec[0], T_spec[1]
        T_com = T_spec[2] if len(T_spec) == 3 else T_ranges[1]
        sp.Trange = [T_low, T_com, T_high]

        c1 = _split_fixed(lines[i + 1][0:75], 15)
        c2 = _split_fixed(lines[i + 2][0:75], 15)
        c3 = _split_fixed(lines[i + 3][0:75], 15)
        sp.hi[0:5] = [float(c) for c in c1[0:5]]
        sp.hi[5] = float(c2[0])
        sp.hi[6] = float(c2[1])
        sp.lo[0] = float(c2[2])
        sp.lo[1] = float(c2[3])
        sp.lo[2] = float(c2[4])
        sp.lo[3:7] = [float(c) for c in c3[0:4]]

        i += 4
        if not any(s.mw == 0.0 for s in specs):
            break
