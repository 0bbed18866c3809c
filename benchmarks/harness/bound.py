"""The least time of a Jacobian evaluation on one H100, counted from the
benchmark's own parse of the mechanism and the call's shapes alone.

Bytes: the states ``y`` (N rows) and the pressures (1 row) read once,
the dense J (N x N) and dy/dt (N) written once, per state, at the
call's item size; plus the mechanism's coefficients once.  Operations:
the closed form per state of the program's ``profiling.dense_ops``
(its derivation is in that function's docstring), worked out from the
reaction categories: per state ln T and the thermo (50 a species), per
reaction 40, 4 per nonzero of nu_net for the Kc sum and 8 for the four
contractions, ``TRANSCENDENTAL_OPS`` per exp / log / pow (kf; Kc's exp
when reversible; k0 and log10 Pr under falloff; Troe's 4, 5 with T2),
12 a species for the closure, 2 per product of the chain rule (each
reduced species a reaction's rate depends on, as reactant, product or
third body of non-unit efficiency, times the species the reaction
changes) and 8 per J entry.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit; no evaluation
kernel uses the tensor cores, so FP64 and FP32 are the CUDA-core rates.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
FLOP_S = {'float64': 34e12, 'float32': 67e12}
ITEM = {'float64': 8, 'float32': 4}
TRANSCENDENTAL_OPS = 20


def ops_per_state(m) -> float:
    """The operations one state's J and dy/dt need (``m``: the
    reference's ``Mechanism``)."""
    N, R = m.N, m.R
    J = N - 1
    calls = (R + m.rev.sum() + 2 * m.fall.sum() +
             (m.troe * (4 + m.troe_T2)).sum())
    nnz_r = (m.nu_net != 0).sum(1)
    red = slice(0, J)
    roles = ((m.nu_f[:, red] > 0).sum(1) + (m.nu_r[:, red] > 0).sum(1) +
             ((m.eff[:, red] != 1.0) & (m.thd | m.fall)[:, None]).sum(1))
    return float(TRANSCENDENTAL_OPS * (1 + calls) + 50 * N + 40 * R +
                 12 * nnz_r.sum() + 12 * N + 2 * (roles * nnz_r).sum() +
                 8 * J * N)


def coefficients(m) -> int:
    """The mechanism's numbers: per species 14 NASA-7 coefficients, the
    switch temperature and the weight; per reaction A, b, E, each
    stoichiometric entry, LOW's 3, Troe's 3 or 4 and each non-unit
    efficiency."""
    eff = ((m.eff != 1.0) & (m.thd | m.fall)[:, None]).sum()
    return int(16 * m.N + 3 * m.R + (m.nu_f > 0).sum() + (m.nu_r > 0).sum()
               + 3 * m.fall.sum() + (m.troe * (3 + m.troe_T2)).sum() + eff)


def jacobian_bound(m, B: int, dtype: str) -> dict:
    """{bytes, operations, least_s, bound_by} of one call on B states."""
    N = m.N
    item = ITEM[dtype]
    moved = item * (N + 1 + N * N + N) * B + item * coefficients(m)
    ops = ops_per_state(m) * B
    tb, to = moved / HBM_BYTES_S, ops / FLOP_S[dtype]
    return {'bytes': float(moved), 'operations': float(ops),
            'least_s': max(tb, to),
            'bound_by': 'bytes' if tb >= to else 'operations'}
