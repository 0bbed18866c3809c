"""Partially stirred reactor (PaSR) simulation.

Port of ``pyjac_tpu/testers/pasr.py`` (the rebuild of the reference's
PaSR test-input generator,
pyjac/functional_tester/partially_stirred_reactor.py), self-contained:
where the reference drives Cantera for particle chemistry and
HP-equilibration, this implementation *dogfoods the framework itself* —
particle reaction substeps integrate the package's own CONP ``dydt``
with its analytical Jacobian (scipy BDF over a block-diagonal
all-particles system, or the package's batched Rosenbrock integrator),
and the pilot stream is obtained by integrating to equilibrium at
constant enthalpy/pressure.

The chemistry (``dydt``, the Jacobian, ``integrate``) runs on the CUDA
card unless the caller asks for the CPU (``device='cpu'``).  The
streams, mixing and pairing are host bookkeeping in numpy, as are the
scalar enthalpy / temperature inversions, whose NASA polynomials are
evaluated on the CPU.

Model (Pope-style, matching reference :745-948):
  * ``num_part`` notional particles, each an (h, P, Y) composition,
  * inflow/outflow events at rate num_part * dt / tau_res replacing
    random particles with inlet-stream compositions (premixed:
    0.95 fuel-air + 0.05 pilot; non-premixed: 0.85 air + 0.05 fuel +
    0.1 pilot, reference :812-818),
  * random pairing/rotation at rate 0.5 num_part dt / tau_pair,
  * pairwise exponential mixing with timescale tau_mix
    (reference :548-576),
  * reaction substeps of length ~0.04 tau_mix.

Output layout matches the reference dump consumed by the testers:
``[steps, particles, 3 + NSP]`` rows of (time, T, P, Y in original
species order) (reference :877).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.constants import PA
from ..core.mech import Mechanism
from ..core.pack import PackedMechanism, pack
from ..ops.common import entry_device


# ---------------------------------------------------------------------------
# thermo helpers on full mass-fraction vectors (original species order is
# handled by callers; internally everything is in packed/pivoted order)
# ---------------------------------------------------------------------------

def _host_T(T):
    return torch.as_tensor(np.atleast_1d(np.asarray(T, np.float64)))


def _enthalpy(packed, T, Y):
    from ..ops.thermo import eval_h
    h = eval_h(packed, _host_T(T)).numpy()
    return float((h[0] * np.asarray(Y)).sum()) if np.ndim(T) == 0 else \
        (h * Y).sum(axis=-1)


def _cp_mix(packed, T, Y):
    from ..ops.thermo import eval_cp
    cp = eval_cp(packed, _host_T(T)).numpy()
    return float((cp[0] * np.asarray(Y)).sum())


def temperature_from_enthalpy(packed, h_target: float, Y: np.ndarray,
                              T_guess: float = 1000.0) -> float:
    """Invert h(T, Y) = h_target by Newton iteration (the HP state set)."""
    T = float(T_guess)
    for _ in range(50):
        h = _enthalpy(packed, T, Y)
        cp = _cp_mix(packed, T, Y)
        dT = (h_target - h) / cp
        T += dT
        if abs(dT) < 1e-10 * max(abs(T), 1.0):
            break
    return T


# ---------------------------------------------------------------------------
# reaction substep: all particles as one block-diagonal BDF solve using the
# framework's own dydt + analytical Jacobian
# ---------------------------------------------------------------------------

class _Chemistry:
    def __init__(self, packed: PackedMechanism, pres: float,
                 device='cuda'):
        from ..ops.dydt import dydt_conp
        from ..ops.jacobian import eval_jacobian

        self.packed = packed
        self.pres = pres
        self.N = packed.n_species
        self.device = entry_device(device)
        self._f = lambda y: dydt_conp(packed, 0.0, pres, y)
        self._J = lambda y: eval_jacobian(packed, 0.0, pres, y)

    def _on_device(self, y):
        return torch.as_tensor(y, device=self.device)

    def _safe(self, z, n_part):
        """Clip trial states into the thermo tables' validity range:
        scipy's BDF probes states outside it during step-size control
        (negative mass fractions, T beyond the NASA fit range), where
        the polynomial exponentials produce non-finite values that
        kill `lu_factor` — CVODE-style guarded RHS evaluation."""
        y = np.array(z, dtype=np.float64).reshape(n_part, self.N)
        y[:, 0] = np.clip(y[:, 0], 250.0, 6000.0)
        y[:, 1:] = np.clip(y[:, 1:], 0.0, 1.0)
        return y

    def rhs(self, t, z, n_part):
        y = self._safe(z, n_part)
        return self._f(self._on_device(y)).cpu().numpy().ravel()

    def jac(self, t, z, n_part):
        import scipy.linalg
        y = self._safe(z, n_part)
        J = self._J(self._on_device(y)).cpu().numpy()
        return scipy.linalg.block_diag(*J)


def reaction_substep(chem: _Chemistry, particles: np.ndarray,
                     dt: float,
                     use_framework: Optional[bool] = None) -> np.ndarray:
    """Advance all particles' chemistry by dt (CONP).

    ``particles`` is (P, N+2): columns [h, P, Y_full...]; T is recovered
    from enthalpy before integration and h is conserved by CONP.

    ``use_framework``: integrate with the framework's own batched
    stiff integrator (:func:`pyjac_tpu_torch.integrate.integrate` on the
    chemistry's device — each particle adapts its own step) instead of
    scipy's monolithic BDF.
    Default: automatic for large systems — scipy factorises the dense
    (P*N)^2 block-diagonal iteration matrix, O((P*N)^3) per step,
    which is intractable at GRI scale (64 particles x 53 species =
    a 3392^2 LU per Newton iteration on this 1-core host)."""
    packed = chem.packed
    n_part = len(particles)
    N = packed.n_species
    if use_framework is None:
        use_framework = n_part * N > 1024
    y0 = np.empty((n_part, N))
    for i, p in enumerate(particles):
        Y = p[2:]
        T = temperature_from_enthalpy(packed, p[0], Y,
                                      T_guess=max(300.0, p[1]))
        y0[i, 0] = T
        y0[i, 1:] = Y[:-1]

    if use_framework:
        from ..integrate import integrate
        rtol, atol, max_steps = getattr(chem, 'tols',
                                        (1e-7, 1e-11, 20000))
        res = integrate(packed, chem._on_device(y0),
                        chem._on_device(np.full(n_part, chem.pres)),
                        float(dt), rtol=rtol, atol=atol,
                        max_steps=max_steps, device=chem.device)
        yf = res.y.cpu().numpy()
        if not np.isfinite(yf).all():
            raise RuntimeError('PaSR reaction substep: non-finite '
                               'framework-integrator state')
    else:
        from scipy.integrate import solve_ivp
        sol = solve_ivp(chem.rhs, (0.0, dt), y0.ravel(),
                        args=(n_part,), method='BDF', jac=chem.jac,
                        rtol=1e-9, atol=1e-12, first_step=dt * 1e-6)
        if not sol.success:
            raise RuntimeError('PaSR reaction substep failed: '
                               + sol.message)
        yf = sol.y[:, -1].reshape(n_part, N)
    out = particles.copy()
    for i in range(n_part):
        Y = np.concatenate([yf[i, 1:], [1.0 - yf[i, 1:].sum()]])
        out[i, 0] = _enthalpy(packed, yf[i, 0], Y)
        out[i, 1] = yf[i, 0]          # cache T for reporting
        out[i, 2:] = Y
    return out


# ---------------------------------------------------------------------------
# streams, mixing, pairing
# ---------------------------------------------------------------------------

def equivalence_ratio_reactants(mech: Mechanism, eq_ratio: float,
                                fuel: Dict[str, float],
                                oxidizer: Dict[str, float]) -> np.ndarray:
    """Mixture mole fractions at a given equivalence ratio
    (reference :383-527): stoichiometric O2 demand per unit fuel is
    C + H/4 - O/2; the oxidizer mixture is scaled to supply it."""
    names = mech.species_names
    idx = {nm.upper(): i for i, nm in enumerate(names)}
    atoms = []
    for sp in mech.specs:
        d = {}
        for el, n in sp.elem:
            d[el.upper()] = d.get(el.upper(), 0) + n
        atoms.append(d)

    def frac_dict(d):
        tot = sum(d.values())
        return {k.upper(): v / tot for k, v in d.items()}

    fuel = frac_dict(fuel)
    oxid = frac_dict(oxidizer)

    o2_demand = 0.0
    for sp, x in fuel.items():
        a = atoms[idx[sp]]
        o2_demand += x * (a.get('C', 0) + a.get('H', 0) / 4.0 -
                          a.get('O', 0) / 2.0)
    x_o2 = oxid.get('O2', 0.0)
    if x_o2 <= 0:
        raise ValueError('oxidizer must contain O2')
    oxid_mult = o2_demand / x_o2

    X = np.zeros(mech.n_species)
    for sp, x in fuel.items():
        X[idx[sp]] += eq_ratio * x
    for sp, x in oxid.items():
        X[idx[sp]] += oxid_mult * x
    return X / X.sum()


def mole_to_mass_fracs(packed, X):
    mw = np.asarray(packed.mw)
    num = X * mw
    return num / num.sum()


def equilibrate_hp(packed, T0: float, pres: float, Y0: np.ndarray,
                   T_ignite: float = 1600.0,
                   device='cuda') -> (float, np.ndarray):
    """Constant-enthalpy/pressure equilibrium (Cantera 'HP' analog) by
    integrating the framework's own CONP chemistry to steady state on
    ``device``, alternated with enthalpy-matching temperature
    correction."""
    chem = _Chemistry(packed, pres, device)
    h_target = _enthalpy(packed, T0, Y0)
    T, Y = T_ignite, np.asarray(Y0, dtype=float)
    for _ in range(4):
        p = np.empty(packed.n_species + 2)
        p[0] = _enthalpy(packed, T, Y)
        p[1] = T
        p[2:] = Y
        p = reaction_substep(chem, p[None], 1.0)[0]   # 1 s ~ equilibrium
        Y = p[2:]
        T = temperature_from_enthalpy(packed, h_target, Y, T_guess=p[1])
    return T, Y


def mix_substep(particles: np.ndarray, dt: float,
                tau_mix: float) -> None:
    """Pairwise exponential relaxation toward pair means on (h, Y)
    (reference :548-576)."""
    decay = 0.5 * (1.0 - math.exp(-2.0 * dt / tau_mix))
    cols = np.r_[0, np.arange(2, particles.shape[1])]   # mix h and Y
    for i in range(0, len(particles) - 1, 2):
        delt = (particles[i, cols] - particles[i + 1, cols]) * decay
        particles[i, cols] -= delt
        particles[i + 1, cols] += delt


def select_pairs(particles: np.ndarray, num_pairs: int, rng,
                 num_skip: int = 0) -> None:
    """Randomly select pairs and move them to the end of the array
    (reference :639-675)."""
    n = len(particles)
    for i_pair in range(num_pairs):
        span = (n // 2) - i_pair - num_skip
        if span <= 0:        # fewer particles than requested pairs
            break
        i = 2 * rng.integers(span)
        j = i + 1
        if rng.random() > 0.5:
            particles[[i, j]] = particles[[j, i]]
        last = n - 2 * (i_pair + num_skip + 1)
        particles[[i, last]] = particles[[last, i]]
        particles[[j, last + 1]] = particles[[last + 1, j]]


# ---------------------------------------------------------------------------
# main simulation
# ---------------------------------------------------------------------------

def run_simulation(mech: Mechanism, case: str, init_temp: float,
                   pres: float, eq_ratio: float,
                   fuel: Dict[str, float], oxidizer: Dict[str, float],
                   complete_products: Optional[List[str]] = None,
                   num_part: int = 100, tau_res: float = 10e-3,
                   tau_mix: float = 1e-3, tau_pair: float = 1e-3,
                   num_res: int = 10, seed: Optional[int] = None,
                   verbose: bool = True,
                   inlet_X: Optional[np.ndarray] = None,
                   pilot: Optional[tuple] = None,
                   chem_tols: Optional[tuple] = None,
                   device='cuda') -> np.ndarray:
    """Run a PaSR simulation; returns particle data
    [steps, particles, 3 + NSP] of (time, T, P, Y original order)
    (reference :745-948).

    ``inlet_X``: reactant mole fractions given directly (original
    species order), bypassing the equivalence-ratio calculation — for
    mechanisms without literal O2/fuel species (e.g. the synthetic
    flagship benchmark mechanism).

    ``pilot``: (T, Y) for the pilot stream, overriding the HP
    equilibration (whose 1-second integration can run away on
    synthetic random-thermo mechanisms).

    The chemistry runs on ``device``: the CUDA card unless the caller
    asks for the CPU.
    """
    device = entry_device(device)
    packed = pack(mech) if not isinstance(mech, PackedMechanism) else mech
    if isinstance(mech, PackedMechanism):
        mech = mech.mech
    rng = np.random.default_rng(seed)
    N = packed.n_species
    back = np.asarray(mech.back_spec_mapping)
    P_pa = pres * PA

    dt_max = 0.1 * min(tau_res, tau_pair)
    dt_sub_target = 0.040 * tau_mix
    num_substeps = 1 + int(dt_max / dt_sub_target)
    time_end = num_res * tau_res

    # --- inlet streams (compositions as [h, T, Y...] rows) ----------------
    if inlet_X is None:
        X_react = equivalence_ratio_reactants(mech, eq_ratio, fuel,
                                              oxidizer)
    else:
        X_react = np.asarray(inlet_X, np.float64)
        X_react = X_react / X_react.sum()
    Y_react = mole_to_mass_fracs(packed, X_react)

    def stream(T, Y, flow):
        row = np.empty(N + 2)
        row[0] = _enthalpy(packed, T, Y)
        row[1] = T
        row[2:] = Y
        return row, flow

    streams = []
    if case.lower() == 'premixed':
        streams.append(stream(init_temp, Y_react, 0.95))
    elif case.lower() == 'non-premixed':
        idx = {nm.upper(): i for i, nm in enumerate(mech.species_names)}
        X_air = np.zeros(N)
        X_air[idx['O2']] = 0.21
        X_air[idx['N2']] = 0.79
        streams.append(stream(init_temp, mole_to_mass_fracs(packed, X_air),
                              0.85))
        X_fuel = np.zeros(N)
        for sp, x in fuel.items():
            X_fuel[idx[sp.upper()]] = x
        streams.append(stream(init_temp,
                              mole_to_mass_fracs(packed, X_fuel), 0.05))
    else:
        raise ValueError("case must be 'premixed' or 'non-premixed'")

    if pilot is not None:
        T_pilot, Y_pilot = float(pilot[0]), np.asarray(pilot[1], float)
    else:
        if verbose:
            print('equilibrating pilot stream (HP)...')
        T_pilot, Y_pilot = equilibrate_hp(packed, init_temp, P_pa, Y_react,
                                          device=device)
    streams.append(stream(T_pilot, Y_pilot,
                          0.05 if case.lower() == 'premixed' else 0.10))
    if verbose:
        print('pilot: T = %.1f K' % T_pilot)

    flows = np.array([s[1] for s in streams])
    flows = flows / flows.sum()
    stream_rows = np.stack([s[0] for s in streams])

    # --- initialise particles with the pilot composition -------------------
    particles = np.tile(stream_rows[-1], (num_part, 1))

    chem = _Chemistry(packed, P_pa, device)
    if chem_tols is not None:
        # (rtol, atol, max_steps) for the framework-integrator
        # chemistry substep — sampling harnesses may trade tolerance
        # for wall-clock
        chem.tols = tuple(chem_tols)
    time = 0.0
    part_out = 0.0
    part_pair = 0.0
    frames = []

    def save(t):
        frame = np.empty((num_part, 3 + N))
        frame[:, 0] = t
        frame[:, 1] = particles[:, 1]
        frame[:, 2] = P_pa
        frame[:, 3:] = particles[:, 2:][:, back]
        frames.append(frame)

    save(time)
    if verbose:
        print('Time [ms]  Temperature [K]')
        print('{:6.2f}  {:9.1f}'.format(0.0, particles[:, 1].mean()))

    while time < time_end:
        dt = min(dt_max, time_end - time)

        part_out += num_part * dt / tau_res
        npart_out = int(round(part_out))
        part_out -= npart_out

        num_fl_pairs = 2 * npart_out
        select_pairs(particles, num_fl_pairs, rng)
        for i in range(npart_out):
            i_str = rng.choice(len(streams), p=flows)
            particles[len(particles) - 2 * (i + 1)] = stream_rows[i_str]

        part_pair += 0.5 * num_part * dt / tau_pair
        num_pairs = int(round(part_pair))
        part_pair -= num_pairs
        if num_pairs > 0:
            select_pairs(particles, num_pairs, rng, num_fl_pairs)
            # rotate the selected pairs (reference :919-924)
            tail = particles[-2 * num_pairs:].copy()
            tmp = tail[-1].copy()
            for i in range(2 * num_pairs - 1, 1, -2):
                tail[i] = tail[i - 2]
            tail[1] = tmp
            particles[-2 * num_pairs:] = tail

        dt_sub = dt / num_substeps
        for _ in range(num_substeps):
            mix_substep(particles, dt_sub, tau_mix)
            particles = reaction_substep(chem, particles, dt_sub)

        time += dt
        save(time)
        if verbose:
            print('{:6.2f}  {:9.1f}'.format(time * 1e3,
                                            particles[:, 1].mean()))

    return np.stack(frames)


def parse_input_file(path: str) -> dict:
    """Parse the YAML input format (reference :951-1013,
    data/pasr_input.yaml)."""
    import yaml
    with open(path) as fh:
        raw = yaml.safe_load(fh)
    return {
        'case': raw['case'],
        'init_temp': float(raw['temperature']),
        'pres': float(raw['pressure']),
        'eq_ratio': float(raw['equivalence ratio']),
        'fuel': dict(raw['fuel']),
        'oxidizer': dict(raw['oxidizer']),
        'complete_products': list(raw.get('complete products', [])),
        'num_part': int(raw['number of particles']),
        'tau_res': float(raw['residence time']),
        'tau_mix': float(raw['mixing time']),
        'tau_pair': float(raw['pairing time']),
        'num_res': int(raw['number of residence times']),
    }


def main(argv=None) -> int:
    """``python -m pyjac_tpu_torch.testers.pasr`` — PaSR data generation
    (reference parity: functional_tester/__main__.py PaSR path)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog='pyjac_tpu_torch.testers.pasr',
        description='Partially stirred reactor simulation (test-input '
                    'generator).')
    parser.add_argument('-i', '--input', required=True,
                        help='Mechanism file.')
    parser.add_argument('-t', '--thermo', default=None)
    parser.add_argument('-y', '--yaml', required=True,
                        help='PaSR YAML input file.')
    parser.add_argument('-o', '--out', default='pasr_output.npy')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--device', default='cuda',
                        help="where the chemistry runs: 'cuda' (default) "
                             "or 'cpu'")
    args = parser.parse_args(argv)

    mech = Mechanism.from_files(args.input, args.thermo)
    cfg = parse_input_file(args.yaml)
    cfg.pop('complete_products')
    data = run_simulation(mech, seed=args.seed, device=args.device, **cfg)
    np.save(args.out, data)
    print('saved %s: %s' % (args.out, data.shape))
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
