"""Frozen copy of the repository's seeded Chemkin generator
``plausible_mechanism`` and its state draw ``random_states``.

The benchmark builds each configuration's mechanism text from this copy,
so a later change to the program's own generator cannot move the
benchmark's inputs.  A CPU test holds the copy to the program's text
and states.

A configuration file names this module as its ``generator`` and gives
``generate``'s arguments under ``args``.
"""

from __future__ import annotations

import io
from typing import List, Optional

import numpy as np


def _fmt_nasa_line(vals, count):
    return ''.join('{: .8E}'.format(v) for v in vals[:count])


def _plausible_thermo(name: str, elems, n_units: int, rng) -> str:
    """NASA-7 entry of a species of ``n_units`` CH2 units: cp grows with
    size and stays positive on [300, 5000] K (rejection-sampled), the
    formation enthalpy is a bounded offset from a size-proportional
    baseline, the entropy constant scales with size."""
    T = np.linspace(300.0, 5000.0, 48)
    for _ in range(64):
        a0 = 2.7 + 1.1 * n_units + rng.uniform(-0.15, 0.15)
        a1 = n_units * rng.uniform(0.5e-3, 1.5e-3)
        a2 = -n_units * rng.uniform(0.05e-6, 0.25e-6)
        a3 = n_units * rng.uniform(0.005e-9, 0.04e-9)
        a4 = -n_units * rng.uniform(0.002e-13, 0.02e-13)
        a5 = -180.0 * n_units + rng.uniform(-600.0, 600.0)
        a6 = 1.5 + 2.0 * n_units + rng.uniform(-0.8, 0.8)
        lo = [a0, a1, a2, a3, a4, a5, a6]
        hi = [a0 + rng.uniform(0.2, 0.6), a1 * rng.uniform(0.25, 0.5),
              a2 * rng.uniform(0.1, 0.3), a3 * rng.uniform(0.1, 0.3),
              a4 * rng.uniform(0.1, 0.3), a5 + rng.uniform(-40.0, 40.0),
              a6 + rng.uniform(-0.6, 0.6)]
        cp_lo = (lo[0] + lo[1] * T + lo[2] * T ** 2 + lo[3] * T ** 3 +
                 lo[4] * T ** 4)
        cp_hi = (hi[0] + hi[1] * T + hi[2] * T ** 2 + hi[3] * T ** 3 +
                 hi[4] * T ** 4)
        if (cp_lo > 1.5).all() and (cp_hi > 1.5).all():
            break
    comp = ''.join('{:<2s}{:>3d}'.format(el, n) for el, n in elems)
    comp = comp.ljust(20)
    line1 = '{:<18s}{:>6s}{}G{:>10.3f}{:>10.3f}{:>9.3f}{:>6s}1'.format(
        name, '', comp, 300.0, 5000.0, 1000.0, '')
    return '\n'.join([line1, _fmt_nasa_line(hi, 5) + '    2',
                      _fmt_nasa_line(hi[5:7] + lo[0:3], 5) + '    3',
                      _fmt_nasa_line(lo[3:7], 4) + '                   4'])


def generate(n_species: int = 53, n_reactions: int = 325,
             seed: int = 42) -> str:
    """Chemkin text of a time-integrable mechanism with GRI-Mech 3.0's
    category mix: one duplicate pair, then ~87% reversible elementary
    exchanges, ~6% third-body associations with two efficiencies, ~7%
    Lindemann / Troe falloff; every reaction conserves the CH2 units, so
    heat release and ln Kc stay bounded.  The last species is inert
    N2."""
    rng = np.random.default_rng(seed)
    assert n_species >= 8
    n_sp = n_species - 1
    names = ['SP{}'.format(k) for k in range(n_sp)] + ['N2']
    sizes = np.asarray([1 + (k % 4) for k in range(n_sp)])
    rng.shuffle(sizes)
    by_size = {s: [names[k] for k in range(n_sp) if sizes[k] == s]
               for s in (1, 2, 3, 4)}

    out = io.StringIO()
    out.write('ELEMENTS\nH C N\nEND\n')
    out.write('SPECIES\n' + ' '.join(names) + '\nEND\n')
    out.write('THERMO ALL\n   300.000  1000.000  5000.000\n')
    for k, nm in enumerate(names):
        if nm == 'N2':
            out.write(_plausible_thermo(nm, [('N', 2)], 2, rng) + '\n')
        else:
            n_u = int(sizes[k])
            out.write(_plausible_thermo(
                nm, [('C', n_u), ('H', 2 * n_u)], n_u, rng) + '\n')
    out.write('END\n')

    def pick_size(s):
        return by_size[s][int(rng.integers(0, len(by_size[s])))]

    def exchange():
        na = int(rng.integers(1, 4))
        nb = int(rng.integers(1, 4))
        tot = na + nb
        parts = [(p, tot - p) for p in (1, 2, 3, 4)
                 if 1 <= tot - p <= 4]
        nc, nd = parts[int(rng.integers(0, len(parts)))]
        return (pick_size(na), pick_size(nb), pick_size(nc),
                pick_size(nd))

    def assoc():
        na = int(rng.integers(1, 3))
        nb = int(rng.integers(1, 5 - na))
        return pick_size(na), pick_size(nb), pick_size(na + nb)

    def arr(lo=10.0, hi=13.3, bl=-0.7, bh=1.2, el=0.0, eh=45000.0):
        return (10.0 ** rng.uniform(lo, hi), rng.uniform(bl, bh),
                rng.uniform(el, eh))

    lines: List[str] = []

    def w(eq, A, b, E, extra: Optional[List[str]] = None):
        lines.append('{:<40s}{:>10.3E}{:>9.3f}{:>12.2f}'.format(
            eq, A, b, E))
        if extra:
            lines.extend(extra)

    a_, b_, c_, d_ = exchange()
    A, b, E = arr()
    w('{}+{}<=>{}+{}'.format(a_, b_, c_, d_), A, b, E, [' DUPLICATE'])
    w('{}+{}<=>{}+{}'.format(a_, b_, c_, d_), A / 5, b, E * 1.05,
      [' DUPLICATE'])
    count = 2
    while count < n_reactions:
        kind = float(rng.integers(0, 100)) / 10.0
        if kind < 8.7:
            a_, b_, c_, d_ = exchange()
            A, b, E = arr()
            w('{}+{}<=>{}+{}'.format(a_, b_, c_, d_), A, b, E)
        elif kind < 9.3:
            a_, b_, c_ = assoc()
            A, b, E = arr(lo=11.0, hi=14.0, el=0.0, eh=8000.0)
            w('{}+{}+M<=>{}+M'.format(a_, b_, c_), A / 1e3, b, E,
              ['{}/{:.2f}/ {}/{:.2f}/'.format(
                  'N2', rng.uniform(0.5, 2.0),
                  pick_size(1), rng.uniform(0.5, 3.0))])
        else:
            a_, b_, c_ = assoc()
            A, b, E = arr(lo=11.0, hi=13.5, bl=-1.0, bh=0.5, el=0.0,
                          eh=8000.0)
            extra = ['LOW / {:.3E} {:.3f} {:.1f} /'.format(
                A * 10.0 ** rng.uniform(2.5, 3.5), b - 1.0, E / 2)]
            if rng.random() < 0.7:
                extra.append('TROE / {:.3f} {:.1f} {:.1f} /'.format(
                    rng.uniform(0.3, 0.9), rng.uniform(80.0, 300.0),
                    rng.uniform(1000.0, 3000.0)))
            w('{}+{}(+M)<=>{}(+M)'.format(a_, b_, c_), A, b, E, extra)
        count += 1

    out.write('REACTIONS\n')
    out.write('\n'.join(lines))
    out.write('\nEND\n')
    return out.getvalue()


def random_states(n_species: int, n_states: int, seed: int = 0,
                  T_range=(800.0, 2500.0), P_range=(0.5e5, 5e5)):
    """(y, P): ``n_states`` states [T, Y_1..Y_{N-1}] with T and P [Pa]
    uniform over their ranges and Dirichlet(0.8) mass fractions floored
    at 1e-6: the draw of the program's ``random_states``."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(*T_range, size=n_states)
    P = rng.uniform(*P_range, size=n_states)
    x = rng.dirichlet(np.full(n_species, 0.8), size=n_states)
    x = (x + 1e-6) / (1.0 + n_species * 1e-6)
    y = np.concatenate([T[:, None], x[:, :-1]], axis=1)
    return y, P
