"""Example: batched ignition-delay computation on the card.

Port of ``examples/ignition_delay.py``: ignition delays for a grid of
initial temperatures and mixtures, every state integrated at once with
the analytical Jacobian (ROS23; the stage Jacobian from the dense fused
kernel K4, one launch per loop iteration on the card).

The mixtures, by mechanism:

* ``--fuel`` / ``--oxidizer`` species (default H2 and O2 + 3.76 N2 where
  the mechanism has them): a grid of equivalence ratios, as the JAX
  script's;
* the default mechanism, the in-repo 53-species flagship (CH2 polymers,
  no H2 or O2): the unburnt side of its PaSR states
  (``tests/data/flagship_states.npz``, the coolest quarter), each brought
  to the grid's temperatures.  Its heat release is bounded by design
  (``testers.synthetic.plausible_mechanism``): a state warms by a few K
  within milliseconds, so the default threshold is 2 K over 3 ms.

A state whose temperature never rises by the threshold within ``t_end``
still gets a delay from the bisection, just under ``t_end``: the table
is followed by the count of states that ignited (:func:`ignited`).

Run:  python -m pyjac_tpu_torch.examples.ignition_delay [mech] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np

from ..core.mech import Mechanism
from ..core.pack import pack
from ..integrate import ignition_delay
from ..ops.common import entry_device
from ..testers import pasr
from ..testers.synthetic import flagship

STATES = os.path.join(os.path.dirname(__file__), '..', '..', 'tests', 'data',
                      'flagship_states.npz')
# (t_end [s], threshold [K]) of the default mechanism's rows and of a
# fuel / oxidizer grid (the JAX script's)
FLAGSHIP_DELAY = (3e-3, 2.0)
COMBUSTION_DELAY = (5e-3, 400.0)


def _species(text: str) -> dict:
    """'A:1,B:3.76' -> {'A': 1.0, 'B': 3.76}."""
    out = {}
    for part in text.split(','):
        name, _, x = part.partition(':')
        out[name.strip()] = float(x or 1.0)
    return out


def ignited(tau, t_end: float, n_points: int):
    """Which delays of ``integrate.ignition_delay`` come from a probe that
    ignited: a state that never does keeps the bisection's upper end at
    ``t_end`` and ends half a bracket under it, at t_end (1 - 2^-(n + 1))
    after n probes; one probe that ignites puts the answer below
    t_end (1 - 2^-n)."""
    n = int(math.log2(n_points)) + 4
    return np.asarray(tau) < t_end * (1.0 - 2.0 ** -n)


def unburnt_rows(n: int):
    """(Y rows (n, N - 1), pressures (n,)): ``n`` of the coolest quarter
    of the flagship's PaSR states, evenly spaced in temperature."""
    d = np.load(STATES)
    order = np.argsort(d['y'][:, 0], kind='stable')
    rows = order[(np.arange(n) * len(order)) // (4 * n)]
    return d['y'][rows, 1:], d['P'][rows]


def initial_states(mech, packed, T0, n_mix: int, fuel=None, oxidizer=None,
                   pressure: float = 101325.0):
    """(y0 (n_mix * len(T0), N), param, the mixtures' labels), mixture
    major, each mixture at every T0 of the grid."""
    fw = np.asarray(mech.fwd_spec_mapping)
    names = [nm.upper() for nm in mech.species_names]
    phi = np.linspace(0.5, 2.0, n_mix)
    if fuel is None and {'H2', 'O2', 'N2'} <= set(names):
        fuel, oxidizer = {'H2': 1.0}, {'O2': 1.0, 'N2': 3.76}
    if fuel is not None:
        Ys = []
        for p in phi:
            X = pasr.equivalence_ratio_reactants(mech, p, fuel, oxidizer)
            X = X / X.sum()
            Ys.append(pasr.mole_to_mass_fracs(packed, X)[fw][:-1])
        P = np.full(n_mix, pressure)
        labels = ['phi=%.1f' % p for p in phi]
    else:
        Ys, P = unburnt_rows(n_mix)
        labels = ['row%d' % k for k in range(n_mix)]
    y0 = np.asarray([np.concatenate([[t], Y]) for Y in Ys for t in T0])
    return y0, np.repeat(P, len(T0)), labels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('mech', nargs='?', default=None,
                    help='mechanism file (default: the in-repo flagship)')
    ap.add_argument('--fuel', type=_species, default=None,
                    help="fuel mole fractions, e.g. 'H2:1'")
    ap.add_argument('--oxidizer', type=_species, default=None,
                    help="oxidizer mole fractions, e.g. 'O2:1,N2:3.76'")
    ap.add_argument('--temps', type=int, default=10)
    ap.add_argument('--t-range', type=float, nargs=2, default=(950., 1400.))
    ap.add_argument('--mixtures', type=int, default=4)
    ap.add_argument('--t-end', type=float, default=None)
    ap.add_argument('--points', type=int, default=64,
                    help='bisection resolution (n_points)')
    ap.add_argument('--rtol', type=float, default=1e-7)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if (args.fuel is None) != (args.oxidizer is None):
        ap.error('--fuel and --oxidizer go together')
    device = entry_device(args.device)

    if args.mech:
        mech = Mechanism.from_files(args.mech)
        packed = pack(mech)
    else:
        mech, packed = flagship()
    T0 = np.linspace(*args.t_range, args.temps)
    y0, P, labels = initial_states(mech, packed, T0, args.mixtures,
                                   args.fuel, args.oxidizer)
    own = args.mech is None and args.fuel is None
    t_end, threshold = FLAGSHIP_DELAY if own else COMBUSTION_DELAY
    t_end = args.t_end or t_end

    tau = ignition_delay(packed, y0, P, t_end, threshold=threshold,
                         n_points=args.points, rtol=args.rtol,
                         jacobian='dd', device=device)
    tau = tau.reshape(len(labels), len(T0))

    print('ignition delay [ms] (rows: mixture, cols: T0; T0 + %g K within '
          '%g s, %s)' % (threshold, t_end, device))
    print('T0[K]:    ' + ' '.join('%7.0f' % t for t in T0))
    for i, lab in enumerate(labels):
        print('%-9s ' % lab + ' '.join('%7.3f' % (t * 1e3) for t in tau[i]))
    lit = ignited(tau, t_end, args.points)
    print('ignited: %d of %d states' % (lit.sum(), lit.size))
    return {'tau': tau, 'ignited': lit, 'y0': y0, 'P': P, 'T0': T0,
            't_end': t_end, 'threshold': threshold, 'points': args.points,
            'rtol': args.rtol, 'packed': packed}


if __name__ == '__main__':
    main()
