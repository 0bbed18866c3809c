"""Structural Jacobian sparsity (the reference's ``touched`` analog).

The reference tracks which Jacobian entries its generated code ever
writes (``touched[]``, create_jacobian.py:2641) and emits a compressed
``sparse_multiplier`` J@v routine over that pattern
(create_jacobian.py:3301-3404). Here the pattern is derived directly
from the packed mechanism structure; the exact J@v product itself is
:func:`pyjac_tpu_torch.ops.jacobian.jacobian_vector_product` (a jvp,
no pattern needed), so the mask's role is introspection, sparse export,
and the planned blocked assembly for very large mechanisms.
"""

from __future__ import annotations

import numpy as np


def structural_sparsity(packed, conp: bool = True) -> np.ndarray:
    """Boolean (N, N) mask of possibly-nonzero Jacobian entries.

    Row/column 0 is the temperature equation. Under CONP the mean
    molecular weight couples every species into every rate through
    rho(Y) (the rank-one r_j term), so any species with nonzero net
    production has a dense row; under CONV the density is fixed and the
    only all-to-all coupling is through the pressure dependence of PLOG/Chebyshev
    rates and the third-body mixture sums.
    """
    N = packed.n_species
    nu = np.asarray(packed.nu_net)            # (R, N)
    produced = np.abs(nu).sum(axis=0) != 0    # species with chemistry

    mask = np.zeros((N, N), dtype=bool)
    # temperature row/column couple to everything with chemistry
    mask[0, :] = True
    mask[1:, 0] = produced[:-1]

    if conp:
        # rank-one rho(Y_j) coupling makes every produced row dense
        mask[1:, 1:] |= produced[:-1, None]
        return mask

    # CONV: species k couples to species j when some reaction produces
    # or consumes k and involves j (as reactant/product, third body with
    # nonzero efficiency, or specific collider), plus the last-species
    # closure column contributions
    involves = (np.abs(np.asarray(packed.nu_fwd)) +
                np.abs(np.asarray(packed.nu_rev))) != 0   # (R, N)
    if packed.has_pres_mod:
        pm_rows = np.asarray(packed.pres_mod_mask)
        # mixture third-body terms couple to all species
        involves = involves | pm_rows[:, None]
    if packed.has_plog or packed.has_cheb:
        # under CONV the pressure depends on mw_avg(Y), so PLOG /
        # Chebyshev rates couple to every species (the aP * mw_avg term
        # in eval_jacobian)
        pd_rows = np.zeros(involves.shape[0], dtype=bool)
        pd_rows[np.asarray(packed.plog_idx)] = True
        pd_rows[np.asarray(packed.cheb_idx)] = True
        involves = involves | pd_rows[:, None]
    touches = np.abs(nu) != 0                 # (R, N): omega_k rows
    # J[k, j] nonzero if exists r with touches[r, k] and involves[r, j]
    pair = touches.T.astype(np.int64) @ involves.astype(np.int64)
    mask[1:, 1:] |= pair[:-1, :-1] != 0
    # last-species elimination: Y_N = 1 - sum Y_j adds the C_N column to
    # every j for reactions involving the last species
    last_rows = involves[:, -1]
    if last_rows.any():
        affected = (np.abs(nu[last_rows]).sum(axis=0) != 0)[:-1]
        mask[1:, 1:] |= affected[:, None]
    return mask


def sparsity_summary(packed) -> dict:
    """Fill-in statistics for both formulations."""
    out = {}
    for conp in (True, False):
        m = structural_sparsity(packed, conp)
        out['conp' if conp else 'conv'] = {
            'nnz': int(m.sum()),
            'total': int(m.size),
            'fill': float(m.mean()),
        }
    return out


def csr_structure(packed, conp: bool = True):
    """CSR pattern (indptr, indices) of the structural sparsity.

    The export target for implicit solvers that accept a fixed pattern
    (the role of the reference's ``sparse_multiplier`` emission,
    create_jacobian.py:3301-3404, whose ``touched``-driven index list
    is the same object). Row-major over the (N, N) Jacobian with the
    temperature equation at row/column 0.
    """
    mask = structural_sparsity(packed, conp)
    indptr = np.zeros(mask.shape[0] + 1, dtype=np.int32)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(mask)[1].astype(np.int32)
    return indptr, indices


def sparse_values(J, indptr, indices):
    """Gather the CSR ``data`` array from dense Jacobians.

    ``J``: (..., N, N) dense batch (a tensor, on any device, or an
    array); returns (..., nnz) in the order of ``csr_structure``, as a
    tensor on ``J``'s device: one indexed load of the static pattern.
    Pairs with :func:`csr_structure` to hand
    ``scipy.sparse.csr_matrix((data[i], indices, indptr))`` per state
    to a host-side implicit solver.
    """
    import torch
    J = torch.as_tensor(J)
    N = len(indptr) - 1
    rows = np.repeat(np.arange(N, dtype=np.int64), np.diff(indptr))
    rows = torch.as_tensor(rows, device=J.device)
    cols = torch.as_tensor(np.asarray(indices, np.int64), device=J.device)
    return J[..., rows, cols]
