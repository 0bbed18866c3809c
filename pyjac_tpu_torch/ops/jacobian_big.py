"""Large-mechanism Jacobian + dy/dt pipeline in float64 (``BigJacobian``).

PyTorch port of ``pyjac_tpu.ops.pallas_dd.PallasDDJacobianBig``
(``pallas_dd.py:2851-3463``), the pipeline for mechanisms of the USC-II
(111 species / 784 reactions) and n-heptane (654 / 2716) classes.  A
pass runs five stages, batch-minor ``(rows, B)`` throughout:

1. **state/thermo pre-stage** (:func:`state_thermo`, plain torch; XLA in
   the JAX package): T, ln T, P, rho, mean molecular weight,
   concentrations, smh, dsmh, and cp/h/dcp for the finish;
2. **reaction parts** (kernel K5, ``csrc/big_parts.cu``; plain version
   :func:`parts_reference`; TPU kernel ``_kernel_dd_parts_tiled``): per
   (reaction, state) the rate constants, equilibrium, pressure
   modification and per-slot assembly values, written as the role array
   ``roles`` (n_roles, R, B) = [vals_f_s; vals_p_s; q; dq_dT; c_u; c_1;
   psi_q; xi_q];
3. **finish** (:func:`finish`, plain torch ``_finish_dd``):
   stoichiometric products with nu_net, dy/dt, the temperature column
   and the column-finishing ``post`` rows of ``jacobian_sparse``;
4. **assembly** (:meth:`BigJacobian.assemble_p1c`, one torch index
   gather of the expanded source stack): the compressed column operand
   ``p1c``;
5. **columns**, either the sparse kernel K6 (``csrc/big_cols_sparse.cu``;
   plain version :func:`cols_sparse_reference`; TPU kernel
   ``_kernel_dd_cols_sparse``) on the compressed operands, or the dense
   kernel K7 (``csrc/big_cols_dense.cu``; plain version
   :func:`cols_dense_reference`; TPU kernel ``_kernel_dd_cols``), which
   assembles each column's operand from the roles by index comparison
   on the column's active reactions only (:func:`dense_active_tables`)
   and contracts it with their nonzero nu_net, the nonzero products of
   the TPU kernel's contraction over all R.

Differences from the TPU pipeline, all consequences of native f64 or of
the card having no VMEM: no double-float pairs or sliced matmuls (so no
``n_dyn``, ``log_rates``, ``compact_pdep`` or ``interpret``), no batch
tiles (``block_b``), no reaction-tile padding; PLOG, Chebyshev and
N == R run in K5 (the TPU refuses them for Mosaic table tiling); the
card runs one configuration of the TPU knobs: K5 always (no XLA parts
stage), the expanded single-gather operand (no four-gather
``_assemble_p1c``), the pres-mod split whenever it leaves rows without
pressure modification, at exactly the pres-mod count (no ``tile_r``),
and one Rmax class (no ``jb`` column blocks, no ``rmax_classes``: K6
follows each column's nonzeros, so neither gains on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.pack import permute_reactions, presmod_first_order
from ..profiling import span
from . import kernels
from .common import F64, as_f64, entry_device
from .jacobian import heat_terms, reaction_parts_at, state_quantities
from .jacobian_sparse import (PARTS_INT_TABLES, column_csr, column_roles,
                              finish_rows, post_col_reference, post_rows,
                              role_tables)
from .thermo import eval_dsmh_dT, eval_smh

# roles after the Sf + Sp slot rows of the ``roles`` array
ROLE_NAMES = ('q', 'dq_dT', 'c_u', 'c_1', 'psi_q', 'xi_q')

# rows of the pre-stage's stacked ``rows`` array read by K5: five (1, B)
# rows, then conc, smh, dsmh (N, B) each
ST_ROWS = ('T', 'logT', 'P', 'rho', 'mw_avg')

# per-reaction category bits of the K5 kernel's ``flags`` table
FLAG_REV, FLAG_THD, FLAG_FALL, FLAG_CHEM, FLAG_TROE, FLAG_SRI, FLAG_T2 = (
    1, 2, 4, 8, 16, 32, 64)

# ---------------------------------------------------------------------------
# column tables (numpy)
# ---------------------------------------------------------------------------

def _ceil8(n):
    return max(8, -(-int(n) // 8) * 8)


def expanded_col_tables(packed) -> dict:
    """The K6 kernel's compressed-column tables
    (``_sparse_col_pack_expanded`` with one-column blocks and one Rmax
    class): ``gidx`` (J, Rmax) source-stack rows and ``nuc`` (J, N,
    Rmax) signed f64 stoichiometry, slots past a column's roles pointing
    at the zero row with zero coefficients.  nuc holds true nu_net, so
    no column is "deep"."""
    rl = column_roles(packed)
    roles = rl['roles']
    Rmax = _ceil8(max(len(x) for x in roles))
    gidx, nuc = role_tables(packed, roles, len(roles), Rmax, rl['n_src'] - 1)
    return dict(Rmax=Rmax, n_src=rl['n_src'], gidx=gidx, nuc=nuc,
                eff_val=rl['eff_val'])


def dense_col_tables(packed) -> dict:
    """The dense column tables: ``nu_net`` (R, N) (the plain version's;
    K7 reads its nonzeros through :func:`dense_active_tables`), the
    reactant/product slot species ``spf``/``spp`` (R, Sf|Sp) with -1 on
    empty slots, the efficiencies ``eff`` (R, N) (``eff_m1``; zeros
    without pressure modification) and the species-pdep index ``pd``
    (R,)."""
    spf = np.where(np.asarray(packed.reac_nu) != 0,
                   np.asarray(packed.reac_sp), -1)
    spp = np.where(np.asarray(packed.prod_nu) != 0,
                   np.asarray(packed.prod_sp), -1)
    nu_net = np.asarray(packed.nu_net, np.float64)
    eff = (np.asarray(packed.eff_m1, np.float64) if packed.has_pres_mod
           else np.zeros_like(nu_net))
    return dict(nu_net=nu_net, spf=spf.astype(np.int32),
                spp=spp.astype(np.int32), eff=eff,
                pd=np.asarray(packed.pdep_sp_idx).astype(np.int32))


def dense_active_tables(tabs) -> dict:
    """The K7 kernel's per-column tables from the :func:`dense_col_tables`
    arrays ``tabs``: ``act`` (J, A) int32, column j's active reactions
    (those whose :func:`p1_dense` operand is not zero by ``spf``, ``spp``,
    ``eff`` and ``pd`` alone) ascending, padded with -1 to ``A``, a
    multiple of 8; and a CSR over (column, output row n) of their nonzero
    ``nu_net[r, n]``: ``ptr`` (J*N + 1,) int32, ``src`` the position of
    each entry's reaction in its column's ``act`` row (int32, ascending
    within a row) and ``coef`` its nu_net (float64)."""
    nu_net = tabs['nu_net']
    N = nu_net.shape[1]
    J = N - 1
    cols = np.arange(J)
    part = ((tabs['spf'][:, :, None] == cols).any(1) |
            (tabs['spp'][:, :, None] == cols).any(1) |
            (tabs['eff'][:, :J] != 0) | (tabs['pd'][:, None] == cols))
    active = [np.nonzero(part[:, j])[0] for j in range(J)]
    act = np.full((J, _ceil8(max(len(a) for a in active))), -1, np.int32)
    counts, src, coef = [], [], []
    for j, rs in enumerate(active):
        act[j, :len(rs)] = rs
        n, i = np.nonzero(nu_net[rs].T)        # row-major: n, then i, ascend
        counts.append(np.bincount(n, minlength=N))
        src.append(i)
        coef.append(nu_net[rs[i], n])
    ptr = np.concatenate([[0], np.cumsum(np.concatenate(counts))])
    return dict(act=act, ptr=ptr.astype(np.int32),
                src=np.concatenate(src).astype(np.int32),
                coef=np.concatenate(coef).astype(np.float64))


def parts_tables(packed) -> dict:
    """The K5 kernel's mechanism tables, flattened row-major, in the
    order of the C struct ``PartsTables`` (``csrc/big_parts.cu``):
    float64 arrays first, then the int32 arrays of
    :data:`PARTS_INT_TABLES`.  Per-reaction nu_net and third-body
    efficiency rows are CSR; PLOG / Chebyshev rows carry their position
    in the gathered PLOG / Chebyshev tables (-1 elsewhere)."""
    from .jacobian_sparse import _csr
    R = packed.n_reactions
    f64 = lambda a: np.ascontiguousarray(np.asarray(a, np.float64).ravel())
    i32 = lambda a: np.ascontiguousarray(np.asarray(a).astype(np.int32)
                                         .ravel())
    nu_net = np.asarray(packed.nu_net, np.float64)
    nu_ptr, nu_col, nu_val = _csr(nu_net)
    eff = (np.asarray(packed.eff_m1, np.float64) if packed.has_pres_mod
           else np.zeros_like(nu_net))
    thd_ptr, thd_col, thd_val = _csr(eff)
    flags = np.zeros(R, np.int64)
    for bit, mask in ((FLAG_REV, packed.rev_mask),
                      (FLAG_THD, packed.thd_only_mask),
                      (FLAG_FALL, packed.falloff_mask),
                      (FLAG_CHEM, packed.chemact_mask),
                      (FLAG_TROE, packed.troe_mask),
                      (FLAG_SRI, packed.sri_mask),
                      (FLAG_T2, packed.troe_has_T2)):
        flags |= np.where(np.asarray(mask, bool), bit, 0)
    plog_pos = np.full(R, -1)
    plog_pos[np.asarray(packed.plog_idx)] = np.arange(len(packed.plog_idx))
    cheb_pos = np.full(R, -1)
    cheb_pos[np.asarray(packed.cheb_idx)] = np.arange(len(packed.cheb_idx))
    return {
        'logA': f64(packed.logA), 'beta': f64(packed.beta),
        'Ta': f64(packed.Ta), 'A_sign': f64(packed.A_sign),
        'sum_nu': f64(packed.sum_nu),
        'ordf': f64(np.asarray(packed.reac_nu).sum(1)),
        'ordr': f64(np.asarray(packed.prod_nu).sum(1)),
        'reac_nu': f64(packed.reac_nu), 'prod_nu': f64(packed.prod_nu),
        'low_logA': f64(packed.low_logA), 'low_beta': f64(packed.low_beta),
        'low_Ta': f64(packed.low_Ta), 'high_logA': f64(packed.high_logA),
        'high_beta': f64(packed.high_beta), 'high_Ta': f64(packed.high_Ta),
        'troe_par': f64(packed.troe_par), 'sri_par': f64(packed.sri_par),
        'nu_val': f64(nu_val), 'thd_val': f64(thd_val),
        'plog_lnP': f64(packed.plog_lnP), 'plog_logA': f64(packed.plog_logA),
        'plog_beta': f64(packed.plog_beta), 'plog_Ta': f64(packed.plog_Ta),
        'cheb_coef': f64(packed.cheb_coef), 'cheb_tlim': f64(packed.cheb_tlim),
        'cheb_plim': f64(packed.cheb_plim), 'inv_mw': f64(packed.inv_mw),
        'reac_sp': i32(packed.reac_sp), 'prod_sp': i32(packed.prod_sp),
        'flags': i32(flags), 'pd': i32(packed.pdep_sp_idx),
        'plog_pos': i32(plog_pos), 'cheb_pos': i32(cheb_pos),
        'plog_n': i32(packed.plog_n),
        'nu_ptr': i32(nu_ptr), 'nu_col': i32(nu_col),
        'thd_ptr': i32(thd_ptr), 'thd_col': i32(thd_col),
    }


# ---------------------------------------------------------------------------
# stages 1, 3 and 4 (plain torch) and the plain versions of K5, K6, K7
# ---------------------------------------------------------------------------

def state_thermo(packed, y_t, P_t, conp: bool = True) -> dict:
    """The state/thermo pre-stage (``_compute_state_thermo``) on (N, B)
    states and a (1, B) pressure (CONP) or density (CONV) row.

    Returns ``rows``, the (5 + 3N, B) array K5 reads ([T, ln T, P, rho,
    mw_avg, conc, smh, dsmh]; no 1/T row: K5 divides by T, as its plain
    version does), views of it under those names, and the
    (1, B) ``dlnrho_dT``, ``dlnP_dT`` and (N, B) ``Y_full``, ``cp``,
    ``h``, ``dcp`` rows the finish reads."""
    s = state_quantities(packed, P_t[0], y_t.T, conp)
    if 'smh' not in s:
        s.update(smh=eval_smh(packed, s['T']),
                 dsmh=eval_dsmh_dT(packed, s['T']))
    rows = torch.cat([torch.stack([s['T'], s['logT'], s['pres'], s['rho'],
                                   s['mw_avg']], 0),
                      s['conc'].T, s['smh'].T, s['dsmh'].T], 0).contiguous()
    N = packed.n_species
    out = {nm: rows[i:i + 1] for i, nm in enumerate(ST_ROWS)}
    out.update(rows=rows, conc=rows[5:5 + N], smh=rows[5 + N:5 + 2 * N],
               dsmh=rows[5 + 2 * N:5 + 3 * N],
               dlnrho_dT=s['dlnrho_dT'][None], dlnP_dT=s['dlnP_dT'][None],
               Y_full=s['y_full'].T)
    cp, h, dcp = heat_terms(packed, s['T'], conp)
    out.update(cp=cp.T, h=h.T, dcp=dcp.T)
    return out


def _batch_major(st) -> dict:
    """:func:`state_quantities`-shaped views of a pre-stage dict."""
    return dict(T=st['T'][0], logT=st['logT'][0], pres=st['P'][0],
                rho=st['rho'][0], mw_avg=st['mw_avg'][0], conc=st['conc'].T,
                smh=st['smh'].T, dsmh=st['dsmh'].T, y_full=st['Y_full'].T,
                dlnrho_dT=st['dlnrho_dT'][0], dlnP_dT=st['dlnP_dT'][0])


def parts_reference(packed, st, conp: bool = True):
    """Plain PyTorch version of the K5 kernel: the (Sf + Sp + 6, R, B)
    role array from the pre-stage ``st``, on every reaction category,
    through :func:`~pyjac_tpu_torch.ops.jacobian.reaction_parts_at`."""
    s = _batch_major(st)
    p = reaction_parts_at(packed, s, conp)
    pmrho = (p['pm'] * s['rho'][:, None])[..., None]            # (B, R, 1)
    vals_f = pmrho * (p['kf'][..., None] * p['dpf'])            # (B, R, Sf)
    vals_p = pmrho * (p['kr'][..., None] * p['dpr'])            # (B, R, Sp)
    rest = torch.stack([p['q'], p['dq_dT'], p['c_u'], p['c_1'],
                        p['psi'] * p['qnet'], p['xi'] * p['qnet']], 0)
    return torch.cat([vals_f.permute(2, 1, 0), vals_p.permute(2, 1, 0),
                      rest.transpose(1, 2)], 0).contiguous()


def finish(packed, st, roles, conp: bool = True) -> dict:
    """The finish (``_finish_dd``): ``col0``, ``f`` (N, B) and the
    ``post`` rows (``jacobian_sparse.post_rows``) from the pre-stage and
    the role array."""
    k = packed.reac_sp.shape[1] + packed.prod_sp.shape[1]
    q, dq_dT, c_u, c_1, psi_q, xi_q = (roles[k + i].T for i in range(6))
    p = dict(_batch_major(st), q=q, dq_dT=dq_dT, c_u=c_u, c_1=c_1)
    return finish_rows(packed, p, psi_q, xi_q,
                       (st['cp'].T, st['h'].T, st['dcp'].T))


def source_stack(roles, n_slot_rows: int, eff_val):
    """The expanded source stack (``_stack_expanded_src``), (n_src, B):
    [vals_f_s; vals_p_s; psi_q * effval_s; xi_q; zero row], with
    ``eff_val`` the (R, S_eff) efficiency slots."""
    B = roles.shape[2]
    psi_q, xi_q = roles[n_slot_rows + 4], roles[n_slot_rows + 5]
    return torch.cat([roles[:n_slot_rows].reshape(-1, B),
                      (psi_q[None] * eff_val.T[..., None]).reshape(-1, B),
                      xi_q, torch.zeros((1, B), dtype=F64,
                                        device=roles.device)], 0)


def cols_sparse_reference(p1c, nuc, inv_mw, post, conp: bool = True):
    """Plain PyTorch version of the K6 kernel: for each column j
    (``nuc`` (J, N, Rmax), ``p1c`` (J * Rmax, B)) contract p1c's block
    with nuc[j] and finish it (``_post_col``).  Returns the (J, N, B)
    columns."""
    J, _, Rmax = nuc.shape
    dcol = torch.einsum('jnr,jrb->jnb', nuc, p1c.view(J, Rmax, -1))
    return post_col_reference(dcol, torch.arange(J, device=p1c.device),
                              inv_mw, post, conp)


def p1_dense(roles, n_f: int, n_p: int, spf, spp, eff, pd, j: int):
    """Column j's dense (R, B) assembly operand (``_p1_col``): its
    forward-slot values minus its product-slot values, plus psi_q times
    the efficiency of species j and xi_q where j is the pdep species."""
    sel = lambda m, v: torch.where(m[:, None], v, 0.0)
    sum_f = sel(spf[:, 0] == j, roles[0])
    for s in range(1, n_f):
        sum_f = sum_f + sel(spf[:, s] == j, roles[s])
    sum_p = sel(spp[:, 0] == j, roles[n_f])
    for s in range(1, n_p):
        sum_p = sum_p + sel(spp[:, s] == j, roles[n_f + s])
    k = n_f + n_p
    return (sum_f - sum_p + roles[k + 4] * eff[:, j:j + 1] +
            sel(pd == j, roles[k + 5]))


def cols_dense_reference(roles, tabs, inv_mw, post, conp: bool = True):
    """Plain PyTorch version of the K7 kernel: every column's dense
    operand (:func:`p1_dense`) contracted with nu_net over all R, then
    ``_post_col``.  ``tabs`` holds the tensors of
    :func:`dense_col_tables`.  Returns the (J, N, B) columns."""
    nu_T = tabs['nu_net'].T
    n_f, n_p = tabs['spf'].shape[1], tabs['spp'].shape[1]
    J = nu_T.shape[0] - 1
    dcol = torch.stack([nu_T @ p1_dense(roles, n_f, n_p, tabs['spf'],
                                        tabs['spp'], tabs['eff'], tabs['pd'],
                                        j) for j in range(J)], 0)
    return post_col_reference(dcol, torch.arange(J, device=roles.device),
                              inv_mw, post, conp)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class BigJacobian(nn.Module):
    """f64 analytical Jacobian + dy/dt for large mechanisms — the port
    of ``PallasDDJacobianBig``.

    The reaction parts always run in K5.  ``sparse_cols`` (default)
    selects the compressed column kernel K6, whose operand is one gather
    of the expanded source stack; ``sparse_cols=False`` selects the
    dense column kernel K7.  When some but not all reactions are
    pressure-modified, they are sorted first (``split_presmod``), so K5
    runs that machinery on rows [0, n_pm) only and a body without it on
    the rest; J and f do not depend on the reaction order.

    The tables are registered buffers, so ``.to(device)`` moves them.
    On CUDA tensors every call launches the kernels (or raises); on CPU
    tensors it runs their plain versions.
    """

    # the buffers the kernels take as int32 (the others float64)
    INT_TABLES = frozenset(
        ['kp_' + k for k in PARTS_INT_TABLES] +
        ['ks_ptr', 'ks_src'] +
        ['kd_' + k for k in ('act', 'ptr', 'src', 'spf', 'spp', 'pd')])

    def __init__(self, packed, conp: bool = True, sparse_cols: bool = True,
                 device='cuda'):
        super().__init__()
        device = entry_device(device)
        self.conp = bool(conp)
        self.sparse_cols = bool(sparse_cols)
        self.perm, self.split_r1 = None, None
        n_pm = int(np.asarray(packed.pres_mod_mask).sum())
        if 0 < n_pm < packed.n_reactions:
            self.perm = presmod_first_order(packed)
            packed = permute_reactions(packed, self.perm)
            self.split_r1 = n_pm
        self.packed = packed
        N, R = packed.n_species, packed.n_reactions
        self.N, self.R, self.J = N, R, N - 1
        self.Sf, self.Sp = packed.reac_sp.shape[1], packed.prod_sp.shape[1]
        self.n_roles = self.Sf + self.Sp + len(ROLE_NAMES)
        self.n_post = post_rows(N, self.J)['fT'][1]
        buf = lambda name, a: self.register_buffer(name, torch.as_tensor(a))
        buf('inv_mw', np.asarray(packed.inv_mw, np.float64))
        for name, arr in parts_tables(packed).items():
            buf('kp_' + name, arr)
        if sparse_cols:
            SC = expanded_col_tables(packed)
            self.Rmax = SC['Rmax']
            rows = np.arange(self.J * self.Rmax).reshape(self.J, self.Rmax)
            ptr, src, coef = column_csr(SC['nuc'], rows)
            buf('eff_val', SC['eff_val'])
            buf('ks_gidx', SC['gidx'].reshape(-1))
            buf('ks_nuc', SC['nuc'])
            buf('ks_ptr', ptr)
            buf('ks_src', src)
            buf('ks_coef', coef)
        else:
            dense = dense_col_tables(packed)
            dense.update(dense_active_tables(dense))
            for name, arr in dense.items():
                buf('kd_' + name, arr)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.inv_mw.device

    def tab(self, prefix: str) -> dict:
        """The registered tables whose names start with ``prefix``,
        without it."""
        return {k[len(prefix):]: v for k, v in self._buffers.items()
                if k.startswith(prefix)}

    # --- the stages ----------------------------------------------------------
    def parts(self, st):
        """Stage 2: the (n_roles, R, B) role array, by K5 on CUDA tensors
        (twice under the split: pres-mod rows, then the rest), by its
        plain version on CPU tensors."""
        if st['rows'].device.type == 'cpu':
            return parts_reference(self.packed, st, self.conp)
        B = st['rows'].shape[1]
        roles = torch.empty((self.n_roles, self.R, B), dtype=F64,
                            device=st['rows'].device)
        if self.split_r1:
            pieces = ((0, self.split_r1, True),
                      (self.split_r1, self.R - self.split_r1, False))
        else:
            pieces = ((0, self.R, self.packed.has_pres_mod),)
        for row0, rows, has_pm in pieces:
            kernels.big_parts(self, st['rows'], roles, row0, rows, has_pm)
        return roles

    def assemble_p1c(self, src):
        """Stage 4: the (J * Rmax, B) compressed column operand
        (``_p1c_from_parts``), one gather of the source stack ``src``."""
        return src[self.ks_gidx]

    def columns(self, roles, post):
        """Stage 5: the (J, N, B) Jacobian columns 1..J."""
        dev = roles.device
        if not self.sparse_cols:
            if dev.type == 'cpu':
                return cols_dense_reference(roles, self.tab('kd_'),
                                            self.inv_mw, post, self.conp)
            return kernels.big_cols_dense(self, roles, post)
        p1c = self.assemble_p1c(source_stack(roles, self.Sf + self.Sp,
                                             self.eff_val))
        if dev.type == 'cpu':
            return cols_sparse_reference(p1c, self.ks_nuc, self.inv_mw, post,
                                         self.conp)
        return kernels.big_cols_sparse(self, p1c, post)

    def call_tr(self, y_t, P_t):
        """Batch-minor entry point: ``y_t`` (N, B), ``P_t`` (1, B) float64
        tensors on the module's device (pressure under CONP, density
        under CONV).  Returns the Jacobian columns 1..J (J, N, B), the
        temperature column ``col0`` (N, B) and dy/dt ``f`` (N, B).  One
        span ``pyjac.jacobian``."""
        with span('pyjac.jacobian'):
            st = state_thermo(self.packed, y_t, P_t, self.conp)
            roles = self.parts(st)
            fin = finish(self.packed, st, roles, self.conp)
            return self.columns(roles, fin['post']), fin['col0'], fin['f']

    def forward(self, y, P):
        """Batch-major: ``y`` (B, N), ``P`` scalar or (B,) -> ``J``
        (B, N, N) with ``J[b, i, j] = d f_i / d y_j`` and ``f`` (B, N),
        float64 on the module's device."""
        y = as_f64(y, self.device)
        if y.dim() != 2 or y.shape[1] != self.N:
            raise ValueError('BigJacobian: states must be (B, %d), got %s'
                             % (self.N, tuple(y.shape)))
        P = torch.broadcast_to(as_f64(P, self.device), y.shape[:1])
        cols, col0, f = self.call_tr(y.T.contiguous(), P[None].contiguous())
        Jt = torch.cat([col0[None], cols], 0)          # [column, row, b]
        return Jt.permute(2, 1, 0), f.T
