"""State-vector utilities: mass/mole conversion, initial conditions.

TPU-native equivalents of the reference's generated ``mass_mole`` source
(reference: pyjac/core/rate_subs.py:2493+ ``write_mass_mole``) and of the
``set_same_initial_conditions`` initializer
(reference: pyjac/core/mech_auxiliary.py:210-311).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core.constants import PA, RU
from .core.pack import PackedMechanism


def mole_to_mass(packed: PackedMechanism, X: np.ndarray) -> np.ndarray:
    """Mole fractions (..., N) -> mass fractions (..., N)."""
    X = np.asarray(X)
    mw = np.asarray(packed.mw)
    num = X * mw
    return num / num.sum(axis=-1, keepdims=True)


def mass_to_mole(packed: PackedMechanism, Y: np.ndarray) -> np.ndarray:
    """Mass fractions (..., N) -> mole fractions (..., N)."""
    Y = np.asarray(Y)
    inv = np.asarray(packed.inv_mw)
    num = Y * inv
    return num / num.sum(axis=-1, keepdims=True)


def get_density(packed: PackedMechanism, T, P, Y) -> np.ndarray:
    """Mixture mass density [kg/m^3] from T [K], P [Pa], mass fractions
    (..., N) (the generated ``getDensity``)."""
    inv = np.asarray(packed.inv_mw)
    mw_avg = 1.0 / (np.asarray(Y) * inv).sum(axis=-1)
    return np.asarray(P) * mw_avg / (RU * np.asarray(T))


def parse_initial_conditions(packed: PackedMechanism,
                             spec: str) -> Tuple[float, float, np.ndarray]:
    """Parse 'T,P,Sp1=x1,Sp2=x2,...' into (T [K], P [Pa], Y mass fractions).

    T in Kelvin, P in atmospheres, species amounts in moles (normalized
    to mole fractions), matching the reference
    (mech_auxiliary.py:222-261; CLI help in utils.py:344-354).
    """
    parts = [p.strip() for p in spec.split(',') if p.strip()]
    if len(parts) < 3:
        raise ValueError(
            'initial conditions need at least T,P,Species=moles: %r' % spec)
    T = float(parts[0])
    P = float(parts[1]) * PA
    names = {nm.upper(): i for i, nm in enumerate(packed.species_names)}
    X = np.zeros(packed.n_species)
    for item in parts[2:]:
        if '=' not in item:
            raise ValueError('bad species entry %r (want NAME=moles)' % item)
        nm, val = item.split('=', 1)
        key = nm.strip().upper()
        if key not in names:
            raise ValueError('unknown species %r in initial conditions'
                             % nm.strip())
        X[names[key]] = float(val)
    total = X.sum()
    if total <= 0:
        raise ValueError('no positive species amounts in %r' % spec)
    X /= total
    Y = mole_to_mass(packed, X)
    return T, P, Y


def state_vector(packed: PackedMechanism, T, Y_full) -> np.ndarray:
    """Build y = [T, Y_1..Y_{N-1}] from temperature and full mass
    fractions (..., N)."""
    T = np.asarray(T)
    Y_full = np.asarray(Y_full)
    return np.concatenate([T[..., None], Y_full[..., :-1]], axis=-1)


def full_mass_fractions(y: np.ndarray) -> np.ndarray:
    """Recover the full (..., N) mass-fraction vector from a state
    vector, via the 1 - sum closure."""
    Y = np.asarray(y)[..., 1:]
    y_N = 1.0 - Y.sum(axis=-1, keepdims=True)
    return np.concatenate([Y, y_N], axis=-1)


def permute_to_internal(packed: PackedMechanism,
                        values: np.ndarray) -> np.ndarray:
    """Reorder per-species data from the original mechanism order to the
    internal (last-species-pivoted) order."""
    fwd = np.asarray(packed.mech.fwd_spec_mapping)
    return np.asarray(values)[..., fwd]


def permute_to_original(packed: PackedMechanism,
                        values: np.ndarray) -> np.ndarray:
    """Inverse of :func:`permute_to_internal`."""
    back = np.asarray(packed.mech.back_spec_mapping)
    return np.asarray(values)[..., back]

