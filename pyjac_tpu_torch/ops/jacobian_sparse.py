"""Compressed ("touched") sparse Jacobian + dy/dt pipeline in float64.

PyTorch port of ``pyjac_tpu.ops.pallas_dd.PallasDDJacobianSparse``
(``pallas_dd.py:2255-2527``), the flagship's main path.  Two stages, each
a hand-written CUDA kernel on the card (``csrc/sparse_stage_a.cu``,
``csrc/sparse_stage_b.cu``, launched from :mod:`.kernels`) with its plain
PyTorch version in this module:

* **stage A** (:func:`stage_a_reference`; TPU kernel ``_kernel_dd_src``)
  — per state: thermo, rates, pressure modification, per-slot assembly
  values, dy/dt and the temperature column.  It writes the stacked
  per-reaction *source array*
  ``[vals_f_s; vals_p_s; psi_q*effval_s; xi_q|0; zero row]``
  (``_stack_expanded_src``), ``col0`` and ``f``, and the nine
  column-finishing rows of ``_postcol_stream_spec``.
* **stage B** (:func:`stage_b_reference`; TPU kernel
  ``_kernel_dd_cols_fused``) — per reduced-species column j: gather the
  column's role rows ``gidx[j]`` of the source array, contract them with
  the column's signed stoichiometry ``nuc[j]`` (N x Rmax instead of the
  dense N x R), scale by 1/W_j and finish with ``_post_col``.  With
  ``fuse_gather=False`` the gather is its own step (``stage_gather``, a
  torch index as the TPU pipeline's ``jnp.take``) and the columns come
  from the pre-gathered operand through K2x (TPU kernel
  ``_kernel_dd_cols_x``), which is K6's kernel
  (``csrc/big_cols_sparse.cu``) on this module's tables; its plain
  version is :func:`stage_b_reference` on the gathered operand.

Both stages take every reaction category the TPU pipeline takes; like
it, the module refuses a sign-flipping PLOG table (:func:`supports`).
Differences from the TPU pipeline, all consequences of native f64:
no double-float pairs, no sliced matmuls (``nuc`` holds the true signed
``nu_net`` columns, so there are no "deep" columns and fractional nu is
accepted), no column padding to a block multiple and no source-stack
padding.  Layout is batch-minor ``(rows, B)`` at the kernel boundary,
one state per CUDA thread with consecutive states at consecutive
addresses (the reference CUDA's ``INDEX()`` structure-of-arrays).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..profiling import span
from . import kernels
from .common import F64, as_f64, entry_device, to_device
from .jacobian import heat_terms, reaction_parts

# the int32 tables of jacobian_big.parts_tables (K5's, which K1, K4 and
# K3 read too), in the C struct's order after the float64 ones
PARTS_INT_TABLES = ('reac_sp', 'prod_sp', 'flags', 'pd', 'plog_pos',
                    'cheb_pos', 'plog_n', 'nu_ptr', 'nu_col', 'thd_ptr',
                    'thd_col')
# the int32 tables of finish_tables (its others are float64)
FINISH_INT_TABLES = ('nut_ptr', 'nut_row')


# ---------------------------------------------------------------------------
# host tables (numpy)
# ---------------------------------------------------------------------------

def eff_slots(packed):
    """Third-body efficiencies of the reduced species as sparse slots.

    Returns ``(S_eff, eff_idx, eff_val)`` with ``eff_idx`` (R, S_eff)
    the species index (-1 padded) and ``eff_val`` (R, S_eff) the raw
    ``eff_m1`` value, packed in the slot order of
    ``pallas_dd._consts_dd``; ``S_eff`` is 0 without pressure
    modification and at least 1 with it.
    """
    R = packed.n_reactions
    if not packed.has_pres_mod:
        return 0, np.zeros((R, 0), np.int64), np.zeros((R, 0))
    eff_red = np.asarray(packed.eff_m1[:, :-1], np.float64)
    nnz_rows = [np.nonzero(eff_red[r])[0] for r in range(R)]
    S_eff = max(max(len(z) for z in nnz_rows), 1)
    eff_idx = np.full((R, S_eff), -1, np.int64)
    eff_val = np.zeros((R, S_eff))
    for r, z in enumerate(nnz_rows):
        eff_idx[r, :len(z)] = z
        eff_val[r, :len(z)] = eff_red[r, z]
    return S_eff, eff_idx, eff_val


def column_tables(packed) -> dict:
    """Expanded per-column role tables (``_sparse_col_pack_expanded``).

    Each (column j, participating reaction) pair expands into one row
    per *role* — forward slot, product slot, third-body efficiency
    slot, specific-pdep species — so column j's assembly operand is a
    pure gather of source rows ``gidx[j]``; the role sign and the
    linear combination across roles live in ``nuc[j, :, i] = sign *
    nu_net[r, :]`` (true f64).  Role order, ``Rmax`` (a multiple of 8,
    at least 8) and the zero-row padding match the TPU tables exactly.

    Also returns the stage-B kernel's per-column CSR over species rows
    (``col_ptr`` (J*N + 1,), ``col_src`` source row, ``col_coef``), and
    the column-independent ``at_last`` / ``pd_last`` coefficients that
    ``_finish_dd`` contracts once into ``v_c``.
    """
    N, R = packed.n_species, packed.n_reactions
    J = N - 1
    rl = column_roles(packed)
    n_src, roles = rl['n_src'], rl['roles']
    Rmax = max(8, -(-max(len(x) for x in roles) // 8) * 8)
    gidx, nuc = role_tables(packed, roles, J, Rmax, n_src - 1)
    ptr, rows, coef = column_csr(nuc, gidx)
    return dict(N=N, R=R, J=J, Sf=rl['Sf'], Sp=rl['Sp'], S_eff=rl['S_eff'],
                n_src=n_src, Rmax=Rmax, gidx=gidx, nuc=nuc,
                eff_val=rl['eff_val'], **finish_coefs(packed),
                col_ptr=ptr, col_src=rows, col_coef=coef)


def column_roles(packed) -> dict:
    """Per reduced-species column j, its role list ``roles[j]`` of
    (source row, reaction, sign) in the TPU tables' order, with the
    source-stack geometry (``Sf``, ``Sp``, ``S_eff``, ``eff_val``,
    ``n_src``)."""
    N, R = packed.n_species, packed.n_reactions
    J = N - 1
    Sf, Sp = packed.reac_sp.shape[1], packed.prod_sp.shape[1]
    reac_sp, prod_sp = np.asarray(packed.reac_sp), np.asarray(packed.prod_sp)
    reac_nu, prod_nu = np.asarray(packed.reac_nu), np.asarray(packed.prod_nu)
    S_eff, eff_idx, eff_val = eff_slots(packed)
    pd = np.asarray(packed.pdep_sp_idx)

    roles = [[] for _ in range(J)]
    for s in range(Sf):
        ok = (reac_nu[:, s] != 0) & (reac_sp[:, s] < J)
        for r in np.nonzero(ok)[0]:
            roles[reac_sp[r, s]].append((s * R + r, r, 1.0))
    for s in range(Sp):
        ok = (prod_nu[:, s] != 0) & (prod_sp[:, s] < J)
        for r in np.nonzero(ok)[0]:
            roles[prod_sp[r, s]].append(((Sf + s) * R + r, r, -1.0))
    if packed.has_pres_mod:
        for r in range(R):
            for s in range(S_eff):
                if eff_idx[r, s] >= 0:
                    roles[eff_idx[r, s]].append(((Sf + Sp + s) * R + r, r,
                                                 1.0))
        for r in np.nonzero((pd >= 0) & (pd < J))[0]:
            roles[pd[r]].append(((Sf + Sp + S_eff) * R + r, r, 1.0))
    return dict(roles=roles, Sf=Sf, Sp=Sp, S_eff=S_eff, eff_val=eff_val,
                n_src=(Sf + Sp + S_eff + 1) * R + 1)


def role_tables(packed, roles, n_rows: int, Rmax: int, zero_row: int):
    """``gidx`` (n_rows, Rmax) source rows and ``nuc`` (n_rows, N, Rmax)
    signed f64 stoichiometry of the role lists; rows past ``roles`` and
    slots past a list's end are the zero row with zero coefficients."""
    nu_net = np.asarray(packed.nu_net, np.float64)
    gidx = np.full((n_rows, Rmax), zero_row, np.int64)
    nuc = np.zeros((n_rows, packed.n_species, Rmax))
    for j, rl in enumerate(roles):
        for i, (src, r, sign) in enumerate(rl):
            gidx[j, i] = src
            nuc[j, :, i] = sign * nu_net[r, :]
    return gidx, nuc


def column_csr(nuc, rows):
    """CSR over (column, species row) of the nonzeros of ``nuc`` (C, N,
    Rmax): ``ptr`` (C*N + 1,) int32, the operand row ``rows[c, i]`` of
    each nonzero (int32) and its coefficient (float64)."""
    C, N, _ = nuc.shape
    c, n, i = np.nonzero(nuc)            # row-major: (c, n) groups ascend
    ptr = np.zeros(C * N + 1, np.int64)
    np.add.at(ptr, c * N + n + 1, 1)
    return (np.cumsum(ptr).astype(np.int32),
            np.asarray(rows)[c, i].astype(np.int32),
            nuc[c, n, i].astype(np.float64))


def finish_coefs(packed) -> dict:
    """Column-independent pressure-modification coefficients hoisted out
    of every column (``_finish_dd``): ``at_last[r] = eff_m1[r, N-1] /
    W_N`` and ``pd_last[r] = -1/W_N`` where reaction r's pdep species is
    the eliminated one; ``v_c = nu^T c_1 - nu^T (psi_q at_last) +
    nu^T (xi_q pd_last)``."""
    N, R = packed.n_species, packed.n_reactions
    inv_mw = np.asarray(packed.inv_mw, np.float64)
    pd = np.asarray(packed.pdep_sp_idx)
    at_last = (np.asarray(packed.eff_m1[:, -1], np.float64) * inv_mw[-1]
               if packed.has_pres_mod else np.zeros(R))
    return dict(at_last=at_last,
                pd_last=np.where(pd == N - 1, -inv_mw[-1], 0.0))


def post_rows(N: int, J: int) -> dict:
    """Row ranges of the nine ``_postcol_stream_spec`` rows inside the
    one (n_post, B) ``post`` array: ``v_u, v_c, eWn, cp`` (N rows each),
    ``fkJ, mr`` (J each), ``ish, mw_avg, fT`` (1 each)."""
    out, row = {}, 0
    for name, n in (('v_u', N), ('v_c', N), ('eWn', N), ('cp', N),
                    ('fkJ', J), ('mr', J), ('ish', 1), ('mw_avg', 1),
                    ('fT', 1)):
        out[name] = (row, row + n)
        row += n
    return out


def supports(packed) -> bool:
    """Whether the mechanism's reaction categories are inside the
    coverage of the port's fused kernels (``SparseJacobian``,
    ``DenseJacobian``, ``F32Jacobian``).

    Mirrors ``pallas_jacobian.supports``, which ``pallas_dd.supports``
    (the TPU sparse and dense pipelines') calls: sign-flipping PLOG tables
    (negative A inside a PLOG ladder) are refused.  Its 50 MB VMEM
    constant clause is a TPU limit and is not ported.  The kernels, as
    their plain versions, take any slot count and Chebyshev order (the
    wide path of ``csrc/kinetics.cuh``).
    """
    return not (packed.has_plog and
                bool((np.asarray(packed.plog_sign) < 0).any()))


def finish_tables(packed) -> dict:
    """The tables of the per-state phases K1 and K4 / K3 share around
    their reaction parts (the thermo, the nu_net^T contractions and the
    closure of ``_finish_dd``), flattened row-major in the order of the C
    struct ``FinishTables`` (``csrc/kinetics.cuh``): float64 arrays
    first, then the int32 arrays of :data:`FINISH_INT_TABLES`.  ``nut_*``
    is the CSR of nu_net^T (per species, its reactions)."""
    f64 = lambda a: np.ascontiguousarray(np.asarray(a, np.float64).ravel())
    i32 = lambda a: np.ascontiguousarray(np.asarray(a).astype(np.int32)
                                         .ravel())
    nut_ptr, nut_row, nut_val = _csr(np.asarray(packed.nu_net,
                                                np.float64).T)
    last = finish_coefs(packed)
    return {
        'mw': f64(packed.mw), 'T_mid': f64(packed.T_mid),
        'a_lo': f64(packed.a_lo), 'a_hi': f64(packed.a_hi),
        'at_last': f64(last['at_last']), 'pd_last': f64(last['pd_last']),
        'nut_val': f64(nut_val),
        'nut_ptr': i32(nut_ptr), 'nut_row': i32(nut_row),
    }


def kernel_tables(packed) -> dict:
    """The stage-A kernel's tables under their buffer names, in the order
    of the C struct ``StageATables`` (``csrc/sparse_stage_a.cu``): K5's
    (``jacobian_big.parts_tables``, ``kp_``), the closure's
    (:func:`finish_tables`, ``kf_``), the third-body efficiency slots
    ``ka_eff_val`` (R, S_eff) that scale ``psi_q`` into the source stack,
    then ``ka_rxn_order``, the order K1 takes the reactions in
    (``jacobian_dense.reaction_order``, K4's: grouped by category)."""
    from .jacobian_big import parts_tables
    from .jacobian_dense import reaction_order
    out = {'kp_' + k: v for k, v in parts_tables(packed).items()}
    out.update(('kf_' + k, v) for k, v in finish_tables(packed).items())
    out['ka_eff_val'] = np.ascontiguousarray(eff_slots(packed)[2].ravel())
    out['ka_rxn_order'] = reaction_order(packed)
    return out


def _csr(mat):
    """Row-wise CSR (ptr, col, val) of the nonzeros of a dense matrix."""
    ptr, col, val = [0], [], []
    for row in mat:
        nz = np.nonzero(row)[0]
        col.extend(nz.tolist())
        val.extend(row[nz].tolist())
        ptr.append(len(col))
    return (np.asarray(ptr), np.asarray(col, np.int64),
            np.asarray(val, np.float64))


# ---------------------------------------------------------------------------
# plain versions of the two kernels
# ---------------------------------------------------------------------------

def stage_a_reference(packed, y_t, P_t, conp: bool = True) -> dict:
    """Plain PyTorch version of the stage-A kernel.

    ``y_t`` (N, B) and ``P_t`` (1, B) float64, batch-minor; ``P_t`` is
    pressure (CONP) or density (CONV).  Returns ``src`` (n_src, B),
    ``col0`` (N, B), ``f`` (N, B) and ``post`` (n_post, B) — exactly the
    arrays the kernel writes (rows of ``post`` per :func:`post_rows`).
    Covers every reaction category through
    :func:`~pyjac_tpu_torch.ops.jacobian.reaction_parts`.
    """
    dev = y_t.device
    S_eff, _, eff_val = eff_slots(packed)
    p = reaction_parts(packed, P_t[0], y_t.T, conp=conp)
    T, rho, y_full = p['T'], p['rho'], p['y_full']
    B = T.shape[0]

    # --- the source stack, (n_src, B) -----------------------------------
    pmrho = (p['pm'] * rho[:, None])[..., None]                 # (B, R, 1)
    vals_f = pmrho * (p['kf'][..., None] * p['dpf'])            # (B, R, Sf)
    vals_p = pmrho * (p['kr'][..., None] * p['dpr'])            # (B, R, Sp)
    psi_q = p['psi'] * p['qnet']
    xi_q = p['xi'] * p['qnet']
    rows = [vals_f[..., s] for s in range(vals_f.shape[-1])]
    rows += [vals_p[..., s] for s in range(vals_p.shape[-1])]
    for s in range(S_eff):
        rows.append(psi_q * torch.as_tensor(eff_val[:, s], device=dev))
    rows.append(xi_q if packed.has_specific_pdep_sp
                else torch.zeros_like(psi_q))
    src = torch.cat([torch.stack(rows, 0).transpose(1, 2).reshape(-1, B),
                     torch.zeros((1, B), dtype=F64, device=dev)], 0)
    out = finish_rows(packed, p, psi_q, xi_q, heat_terms(packed, T, conp))
    return dict(src=src.contiguous(), **out)


def finish_rows(packed, p, psi_q, xi_q, heat) -> dict:
    """Stoichiometric contractions and thermodynamic closure
    (``_finish_dd``), batch-major: from the state quantities of ``p``
    (``T``, ``rho``, ``mw_avg``, ``y_full``, ``dlnrho_dT``; (B,) or
    (B, N)), its per-reaction ``q``, ``dq_dT``, ``c_u``, ``c_1`` and
    ``psi_q``, ``xi_q`` (B, R), and ``heat`` = (cp or cv, h or u,
    dcp/dT) (B, N).  Returns ``col0`` and ``f`` (N, B) and the ``post``
    rows (n_post, B), batch-minor and contiguous."""
    J = packed.n_species - 1
    T, rho, y_full = p['T'], p['rho'], p['y_full']
    dev = T.device
    last = finish_coefs(packed)
    tb = to_device(packed, dev)
    mw, nu_net = tb.mw, tb.nu_net
    omega = p['q'] @ nu_net                                      # (B, N)
    domega_dT = p['dq_dT'] @ nu_net
    v_u = p['c_u'] @ nu_net
    cv = p['c_1']
    if packed.has_pres_mod:
        cv = cv - psi_q * torch.as_tensor(last['at_last'], device=dev)
        if packed.has_specific_pdep_sp:
            cv = cv + xi_q * torch.as_tensor(last['pd_last'], device=dev)
    v_c = cv @ nu_net
    cp, e_spec, dcp = heat
    sh = torch.sum(cp * y_full, dim=-1)
    dsh_dT = torch.sum(dcp * y_full, dim=-1)
    rho_inv = 1.0 / rho
    fk = omega * mw * rho_inv[:, None]
    denomT = rho * sh
    eWn = e_spec * mw / denomT[:, None]
    fT = -torch.sum(eWn * omega, dim=-1)
    dlnrho_dT = p['dlnrho_dT']
    JYT = (mw[:J] * rho_inv[:, None] * domega_dT[:, :J] -
           fk[:, :J] * dlnrho_dT[:, None])
    JTT = (-(torch.sum(cp * mw * omega / denomT[:, None], dim=-1) +
             torch.sum(eWn * domega_dT, dim=-1)) -
           fT * (dlnrho_dT + dsh_dT / sh))
    col0 = torch.cat([JTT[:, None], JYT], 1).T
    f = torch.cat([fT[:, None], fk[:, :J]], 1).T
    post = torch.cat([v_u, v_c, eWn, cp, fk[:, :J],
                      mw[:J] * rho_inv[:, None], (1.0 / sh)[:, None],
                      p['mw_avg'][:, None], fT[:, None]], 1).T
    return dict(col0=col0.contiguous(), f=f.contiguous(),
                post=post.contiguous())


def stage_b_reference(gidx, nuc, inv_mw, src, post, conp: bool = True):
    """Plain PyTorch version of the stage-B kernel.

    ``gidx`` (J, Rmax) source rows, ``nuc`` (J, N, Rmax) signed
    stoichiometry, ``inv_mw`` (N,), ``src`` (n_src, B) and ``post``
    (n_post, B) from stage A.  Returns the Jacobian columns 1..J as
    (J, N, B): ``out[j, 0]`` is d(dT/dt)/dY_j and ``out[j, 1 + k]`` is
    d(dY_k/dt)/dY_j.
    """
    J = nuc.shape[0]
    p1 = src[gidx]                                          # (J, Rmax, B)
    dcol = torch.einsum('jnr,jrb->jnb', nuc, p1)
    return post_col_reference(dcol, torch.arange(J, device=src.device),
                              inv_mw, post, conp)


def post_col_reference(dcol, cols, inv_mw, post, conp: bool = True):
    """``_post_col`` on the raw contractions ``dcol`` (C, N, B) of the
    Jacobian columns ``cols`` (C,) (reduced-species indices): the 1/W_j
    scale, the rank-one terms and the temperature row.  Returns (C, N, B)
    with row 0 the temperature row."""
    N = dcol.shape[1]
    J = N - 1
    g = {k: post[a:b] for k, (a, b) in post_rows(N, J).items()}
    w = inv_mw[cols]
    u = w - inv_mw[N - 1]                                          # (C,)
    dcol = dcol * w[:, None, None]
    dcol = dcol + g['v_u'][None] * u[:, None, None] + g['v_c'][None]
    if conp:
        r = -(g['mw_avg'] * u[:, None])                             # (C, B)
    else:
        r = torch.zeros((len(cols), post.shape[1]), dtype=F64,
                        device=post.device)
    JYY = g['mr'][None] * dcol[:, :J] - g['fkJ'][None] * r[:, None, :]
    JTY = (-torch.sum(g['eWn'][None] * dcol, dim=1) -
           g['fT'] * (r + (g['cp'][cols] - g['cp'][N - 1]) * g['ish']))
    return torch.cat([JTY[:, None], JYY], 1)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class SparseJacobian(nn.Module):
    """f64 analytical Jacobian + dy/dt through the compressed-column
    pipeline — the port of ``PallasDDJacobianSparse``.

    ``fuse_gather=True`` (the default here, the card's measured path)
    gathers each column's operand inside the stage-B kernel K2;
    ``fuse_gather=False`` (the JAX package's default) gathers it first
    with a torch index and runs K2x on the result.  Both give the same
    J.

    The mechanism tables are registered buffers, so ``.to(device)``
    moves them.  On CUDA tensors every call launches the two kernels of
    :mod:`.kernels` (or raises); on CPU tensors it runs their plain
    versions.  A mechanism :func:`supports` refuses raises
    ``NotImplementedError``, as ``PallasDDJacobianSparse`` does.
    """

    # what the kernel launcher reads of the tables: the buffers its
    # kernels take as int32 (the others float64), and the tile kernel
    # kernels.tile_plan plans for this module
    INT_TABLES = frozenset(
        ['kp_' + k for k in PARTS_INT_TABLES] +
        ['kf_' + k for k in FINISH_INT_TABLES] +
        ['ka_rxn_order', 'col_ptr', 'col_src', 'kx_ptr', 'kx_src'])
    TILE_KERNEL = 'stage_a'

    def __init__(self, packed, conp: bool = True, fuse_gather: bool = True,
                 device='cuda'):
        super().__init__()
        device = entry_device(device)
        if not supports(packed):
            raise NotImplementedError(
                'sign-flipping PLOG tables are outside SparseJacobian\'s '
                'coverage (as PallasDDJacobianSparse)')
        self.packed = packed
        self.conp = bool(conp)
        self.fuse_gather = bool(fuse_gather)
        ct = column_tables(packed)
        self.N, self.R, self.J = ct['N'], ct['R'], ct['J']
        self.Sf, self.Sp, self.S_eff = ct['Sf'], ct['Sp'], ct['S_eff']
        self.n_src, self.Rmax = ct['n_src'], ct['Rmax']
        self.n_post = post_rows(self.N, self.J)['fT'][1]
        self.register_buffer('gidx', torch.as_tensor(ct['gidx']))
        self.register_buffer('nuc', torch.as_tensor(ct['nuc']))
        self.register_buffer('inv_mw', torch.as_tensor(
            np.asarray(packed.inv_mw, np.float64)))
        for name in ('col_ptr', 'col_src', 'col_coef'):
            self.register_buffer(name, torch.as_tensor(ct[name]))
        if not self.fuse_gather:
            # K2x's CSR over the rows of the gathered operand
            rows = np.arange(self.J * self.Rmax).reshape(self.J, self.Rmax)
            for name, arr in zip(('kx_ptr', 'kx_src', 'kx_coef'),
                                 column_csr(ct['nuc'], rows)):
                self.register_buffer(name, torch.as_tensor(arr))
        for name, arr in kernel_tables(packed).items():
            self.register_buffer(name, torch.as_tensor(arr))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.inv_mw.device

    # --- the two stages ------------------------------------------------------
    def stage_a(self, y_t, P_t) -> dict:
        """Stage A on (N, B) states and a (1, B) pressure/density row."""
        if y_t.device.type == 'cpu':
            return stage_a_reference(self.packed, y_t, P_t, self.conp)
        return kernels.stage_a(self, y_t, P_t)

    def stage_b(self, src, post):
        """Stage B: the (J, N, B) Jacobian columns 1..J."""
        if src.device.type == 'cpu':
            return stage_b_reference(self.gidx, self.nuc, self.inv_mw, src,
                                     post, self.conp)
        return kernels.stage_b(self, src, post)

    def stage_gather(self, src):
        """The pre-gathered column operand (J * Rmax, B) of the
        ``fuse_gather=False`` path: rows ``gidx`` of the source stack."""
        return src[self.gidx.reshape(-1)]

    def stage_b_x(self, p1, post):
        """Stage B on the pre-gathered operand ``p1`` (K2x): the
        (J, N, B) Jacobian columns 1..J."""
        if p1.device.type == 'cpu':
            rows = torch.arange(self.J * self.Rmax).reshape(self.J, self.Rmax)
            return stage_b_reference(rows, self.nuc, self.inv_mw, p1, post,
                                     self.conp)
        return kernels.stage_b_x(self, p1, post)

    def call_tr(self, y_t, P_t):
        """Batch-minor entry point: ``y_t`` (N, B), ``P_t`` (1, B) float64
        tensors on the module's device.  Returns the Jacobian columns
        1..J (J, N, B), the temperature column ``col0`` (N, B) and
        dy/dt ``f`` (N, B).  One span ``pyjac.jacobian``."""
        with span('pyjac.jacobian'):
            a = self.stage_a(y_t, P_t)
            if self.fuse_gather:
                cols = self.stage_b(a['src'], a['post'])
            else:
                cols = self.stage_b_x(self.stage_gather(a['src']),
                                      a['post'])
            return cols, a['col0'], a['f']

    def forward(self, y, P):
        """Batch-major: ``y`` (B, N), ``P`` scalar or (B,) -> ``J``
        (B, N, N) with ``J[b, i, j] = d f_i / d y_j`` and ``f`` (B, N),
        float64 on the module's device."""
        y = as_f64(y, self.device)
        if y.dim() != 2 or y.shape[1] != self.N:
            raise ValueError('SparseJacobian: states must be (B, %d), got %s'
                             % (self.N, tuple(y.shape)))
        P = torch.broadcast_to(as_f64(P, self.device), y.shape[:1])
        cols, col0, f = self.call_tr(y.T.contiguous(),
                                     P[None].contiguous())
        Jt = torch.cat([col0[None], cols], 0)          # [column, row, b]
        return Jt.permute(2, 1, 0), f.T
