"""Dense fused Jacobian + dy/dt in float64 (``DenseJacobian``).

PyTorch port of ``pyjac_tpu.ops.pallas_dd.PallasDDJacobian``
(``pallas_dd.py:2530-2641``), the dense kernel that
``integrate(jacobian='dd')`` evaluates its stage Jacobian with.  On the
card one hand-written CUDA kernel, K4 (``csrc/dense_fused.cu``; TPU
kernel ``_kernel_dd``), computes the whole Jacobian and dy/dt of a batch
of states in one launch.  Its plain PyTorch version,
:func:`dense_reference`, is built from the large-mechanism pipeline's
plain functions: the state/thermo pre-stage, K5's plain version, the
finish and K7's plain dense column contraction.

Differences from the TPU kernel, all consequences of native f64 or of
the card having no VMEM: no double-float pairs or sliced matmuls (so no
``n_dyn``, ``log_rates``, ``compact_pdep`` or ``interpret``), no batch
tiles (``block_b``: the kernel masks the ragged batch edge) and no column
groups (``col_group``: each column walks its own nonzeros).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..profiling import span
from . import kernels
from .common import F64, as_f64, cached, entry_device
from .jacobian_big import (cols_dense_reference, dense_col_tables, finish,
                           parts_reference, parts_tables, state_thermo)
from .jacobian_sparse import (FINISH_INT_TABLES, PARTS_INT_TABLES,
                              column_csr, column_roles, finish_tables,
                              role_tables, supports)

# the int32 tables of fused_tables
FUSED_INT_TABLES = FINISH_INT_TABLES + ('col_src', 'rxn_order', 'col_order')


def operand_csr(packed):
    """K4's column tables: per (column j, species row n) the nonzeros of
    column j's assembly operand x nu_net, as a CSR over the rows of the
    role array (Sf + Sp + 6, R, B) of ``parts_reference``: ``ptr``
    (J*N + 1,) int32, the role row of each nonzero (int32) and its
    coefficient (float64).

    The entries are those of the expanded role tables
    (``jacobian_sparse.role_tables``, the sparse pipeline's), with each
    source-stack row mapped onto the role array: a slot value is its own
    role row; a third-body efficiency slot ``psi_q * eff`` becomes the
    ``psi_q`` row with ``eff`` folded into the coefficient; the
    species-pdep row is the ``xi_q`` row."""
    R = packed.n_reactions
    J = packed.n_species - 1
    rl = column_roles(packed)
    k, S_eff = rl['Sf'] + rl['Sp'], rl['S_eff']
    Rmax = max(1, max(len(x) for x in rl['roles']))
    gidx, nuc = role_tables(packed, rl['roles'], J, Rmax, rl['n_src'] - 1)
    ptr, src, coef = column_csr(nuc, gidx)
    src = src.astype(np.int64)
    sec, r = src // R, src % R
    assert (sec <= k + S_eff).all(), 'a nonzero on the zero row'
    eff = sec - k
    is_eff = (eff >= 0) & (eff < S_eff)
    row = np.where(sec < k, src,
                   np.where(is_eff, (k + 4) * R + r, (k + 5) * R + r))
    if S_eff:
        scale = rl['eff_val'][r, np.clip(eff, 0, S_eff - 1)]
        coef = np.where(is_eff, coef * scale, coef)
    return ptr, row.astype(np.int32), coef.astype(np.float64)


def reaction_order(packed) -> np.ndarray:
    """The order K4 takes the reactions in: grouped by the branches its
    reaction body takes (the category flags, PLOG, Chebyshev), ascending
    within a group, so the few reactions a warp shares take one path."""
    t = parts_tables(packed)
    key = (t['flags'].astype(np.int64) | (t['plog_pos'] >= 0) << 8 |
           (t['cheb_pos'] >= 0) << 9)
    return np.argsort(key, kind='stable').astype(np.int32)


def column_row_order(col_ptr, N: int) -> np.ndarray:
    """The order K4 takes each column's species rows in, longest CSR row
    first (stable), so the few rows a warp shares walk alike, with each
    row's CSR range: (J*N*3,) int32, position i of column j at
    [3 (j N + i), +3) = (row n, ptr[j N + n], ptr[j N + n + 1]), so one
    record gives a row and its range."""
    ptr = np.asarray(col_ptr, np.int64)
    lens = np.diff(ptr).reshape(-1, N)
    n = np.argsort(-lens, axis=1, kind='stable')
    at = (np.arange(lens.shape[0])[:, None] * N + n).ravel()
    return np.stack([n.ravel(), ptr[at], ptr[at + 1]], 1).astype(
        np.int32).ravel()


def fused_tables(packed) -> dict:
    """The K4 kernel's tables after K5's (``jacobian_big.parts_tables``),
    in the order of the C struct ``DenseTables`` (``csrc/
    dense_fused.cu``): the per-state phases' (``jacobian_sparse.
    finish_tables``), the column CSR's entries (``col_coef``,
    ``col_src`` of :func:`operand_csr`), :func:`reaction_order`, then
    :func:`column_row_order` (each row's range of those entries).  The int32
    arrays are those of :data:`FUSED_INT_TABLES`."""
    col_ptr, col_src, col_coef = operand_csr(packed)
    return {**finish_tables(packed),
            'col_coef': np.ascontiguousarray(col_coef, np.float64),
            'col_src': np.ascontiguousarray(col_src, np.int32),
            'rxn_order': reaction_order(packed),
            'col_order': column_row_order(col_ptr, packed.n_species)}


def dense_reference(packed, y_t, P_t, conp: bool = True):
    """Plain PyTorch version of the K4 kernel (the math of ``_kernel_dd``:
    ``_compute_dd``, then ``_column_block_dd`` over every column).

    ``y_t`` (N, B) and ``P_t`` (1, B) float64, batch-minor; ``P_t`` is
    pressure (CONP) or density (CONV).  Returns ``Jt`` (N, N, B) in the
    TPU kernel's [column, row, batch] layout, column 0 the temperature
    column, and dy/dt ``f`` (N, B)."""
    dev = y_t.device
    tabs = cached(packed, ('dense_col_tables', str(dev)), lambda: {
        k: torch.as_tensor(v, device=dev)
        for k, v in dense_col_tables(packed).items()})
    inv_mw = cached(packed, ('inv_mw', str(dev)), lambda: torch.as_tensor(
        np.asarray(packed.inv_mw, np.float64), device=dev))
    st = state_thermo(packed, y_t, P_t, conp)
    roles = parts_reference(packed, st, conp)
    fin = finish(packed, st, roles, conp)
    cols = cols_dense_reference(roles, tabs, inv_mw, fin['post'], conp)
    return torch.cat([fin['col0'][None], cols], 0), fin['f']


class DenseJacobian(nn.Module):
    """f64 analytical Jacobian + dy/dt in one fused kernel — the port of
    ``PallasDDJacobian``.

    The tables are registered buffers, so ``.to(device)`` moves them.
    On CUDA tensors every call launches K4 (or raises); on CPU tensors it
    runs :func:`dense_reference`.  A mechanism :func:`supports` refuses
    raises ``NotImplementedError``.
    """

    # what the kernel launcher reads of the tables: the buffers K4 and the
    # dy/dt kernel take as int32 (the others float64), and the tile kernel
    # kernels.tile_plan plans for this module
    INT_TABLES = frozenset(['kp_' + k for k in PARTS_INT_TABLES] +
                           ['kf_' + k for k in FUSED_INT_TABLES])
    TILE_KERNEL = 'dense_fused'

    def __init__(self, packed, conp: bool = True, device='cuda'):
        super().__init__()
        device = entry_device(device)
        if not supports(packed):
            raise NotImplementedError(
                'sign-flipping PLOG tables are outside DenseJacobian\'s '
                'coverage (as PallasDDJacobian)')
        self.packed = packed
        self.conp = bool(conp)
        self.N, self.R = packed.n_species, packed.n_reactions
        self.J = self.N - 1
        buf = lambda name, a: self.register_buffer(name, torch.as_tensor(a))
        buf('inv_mw', np.asarray(packed.inv_mw, np.float64))
        for name, arr in parts_tables(packed).items():
            buf('kp_' + name, arr)
        for name, arr in fused_tables(packed).items():
            buf('kf_' + name, arr)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.inv_mw.device

    def call_tr(self, y_t, P_t):
        """Batch-minor entry point: ``y_t`` (N, B), ``P_t`` (1, B)
        float64 tensors on the module's device (pressure under CONP,
        density under CONV).  Returns ``Jt`` (N, N, B), [column, row,
        batch], and dy/dt ``f`` (N, B).  One span ``pyjac.jacobian``."""
        with span('pyjac.jacobian'):
            if y_t.device.type == 'cpu':
                return dense_reference(self.packed, y_t, P_t, self.conp)
            return kernels.dense_fused(self, y_t, P_t)

    def forward(self, y, P):
        """Batch-major: ``y`` (B, N), ``P`` scalar or (B,) -> ``J``
        (B, N, N) with ``J[b, i, j] = d f_i / d y_j`` and ``f`` (B, N),
        float64 on the module's device."""
        y = as_f64(y, self.device)
        if y.dim() != 2 or y.shape[1] != self.N:
            raise ValueError('DenseJacobian: states must be (B, %d), got %s'
                             % (self.N, tuple(y.shape)))
        P = torch.broadcast_to(as_f64(P, self.device), y.shape[:1])
        Jt, f = self.call_tr(y.T.contiguous(), P[None].contiguous())
        return Jt.permute(2, 1, 0), f.T
