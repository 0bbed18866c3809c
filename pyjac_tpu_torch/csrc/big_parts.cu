// Reaction parts of the large-mechanism pipeline (K5), float64, sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py
// `_kernel_dd_parts_tiled` (launched from `PallasDDJacobianBig`'s
// parts_stage): `_compute_reaction_parts` + `_pdep_falloff_vals` on a
// range of reaction rows, from the (5 + 3N, B) state/thermo pre-stage
// rows [T, ln T, P, rho, mw_avg, conc, smh, dsmh].  It writes the role
// array roles (Sf + Sp + 6, R, B):
//   [vals_f_s; vals_p_s; q; dq_dT; c_u; c_1; psi_q; xi_q].
// Every reaction category: Arrhenius (negative A included), PLOG,
// Chebyshev, reversible via Kc, third-body, Lindemann / Troe / SRI
// falloff, chemically activated, species-specific pdep, fractional
// stoichiometry; CONP and CONV.  Its plain PyTorch version is
// `parts_reference` in pyjac_tpu_torch/ops/jacobian_big.py, whose
// operations (ops/jacobian.reaction_parts_at) each line here follows in
// the same order, so that kernel and plain version round alike.
//
// What bounds it on this card: bytes.  A (reaction, state) pair writes
// Sf + Sp + 6 doubles (80 B for the 654-species class) and reads a few
// concentration / smh rows that the blocks of one state tile share
// through L2, against a few hundred f64 operations (5-10 exp/log).
//
// What the design does about it: one thread per (reaction, state),
// states fastest, so every load and store of a warp covers 32 consecutive
// doubles and every table read is one address for the whole block (a
// broadcast).  The reaction is the fastest block index, so the blocks
// that share one state tile run together and find its rows in L2.  Under
// `split_presmod` the pressure-modified reactions come first; the rows
// after them run the HAS_PM = false instantiation, which drops that
// machinery.

#include <cuda_runtime.h>

#include <cstring>

#define MAX_SLOTS 8
#define MAX_CHEB 16
#define RU 8314.4621
#define LN10 2.302585092994046
#define TINY 1.0e-300

// flag bits (jacobian_big.FLAG_*)
#define F_REV 1
#define F_THD 2
#define F_FALL 4
#define F_CHEM 8
#define F_TROE 16
#define F_SRI 32
#define F_T2 64

// matches the numpy table order of jacobian_big.parts_tables
struct PartsTables {
  const double *logA, *beta, *Ta, *A_sign, *sum_nu, *ordf, *ordr;
  const double *reac_nu, *prod_nu;
  const double *low_logA, *low_beta, *low_Ta, *high_logA, *high_beta,
      *high_Ta;
  const double *troe_par, *sri_par, *nu_val, *thd_val;
  const double *plog_lnP, *plog_logA, *plog_beta, *plog_Ta;
  const double *cheb_coef, *cheb_tlim, *cheb_plim, *inv_mw;
  const int *reac_sp, *prod_sp, *flags, *pd, *plog_pos, *cheb_pos, *plog_n;
  const int *nu_ptr, *nu_col, *thd_ptr, *thd_col;
};
#define N_TABLES 38
static_assert(sizeof(PartsTables) == N_TABLES * sizeof(void*),
              "PartsTables must be N_TABLES pointers");

struct PartsDims {
  int N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, row0, rows;
  double ln_pa_ru;
};
#define N_DIMS 9

__device__ __forceinline__ double ipow(double c, int k) {
  // c^k as repeated multiplication, left to right (the plain version's
  // unrolled integer powers)
  if (k <= 0) return 1.0;
  double acc = c;
  for (int i = 1; i < k; ++i) acc = acc * c;
  return acc;
}

#define AT(arr, r) (arr)[(size_t)(r) * (size_t)B + (size_t)b]

// concentration products of one side: powers, their product, and the
// slot derivatives d(prod)/dC_s (`_product_and_slot_derivs`)
__device__ __forceinline__ double slot_products(
    const double* __restrict__ conc, long long B, long long b, int S,
    const int* sp, const double* nu, int has_frac, double* pw,
    double* dp) {
  double total = 1.0;
  for (int s = 0; s < S; ++s) {
    const double c = AT(conc, sp[s]);
    if (nu[s] == 0.0) pw[s] = 1.0;
    else pw[s] = has_frac ? pow(c, nu[s]) : ipow(c, (int)nu[s]);
    total = s == 0 ? pw[0] : total * pw[s];
  }
  for (int s = 0; s < S; ++s) {
    const double c = AT(conc, sp[s]);
    double excl = 1.0;
    for (int s2 = 0; s2 < S; ++s2)
      if (s2 != s) excl = excl * pw[s2];
    double dpow;
    if (nu[s] == 0.0) dpow = 0.0;
    else if (has_frac) dpow = nu[s] * pow(c, nu[s] - 1.0);
    else dpow = nu[s] * ipow(c, (int)nu[s] - 1);
    dp[s] = dpow * excl;
  }
  return total;
}

template <bool HAS_PM>
__global__ void __launch_bounds__(128)
big_parts_kernel(PartsTables t, PartsDims d, const double* __restrict__ st,
                 long long B, double* __restrict__ roles) {
  const int r = d.row0 + blockIdx.x;
  const long long b = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B || blockIdx.x >= (unsigned)d.rows) return;
  const int N = d.N, R = d.R, Sf = d.Sf, Sp = d.Sp, conp = d.conp;
  const int fl = t.flags[r];

  // --- state (jacobian_big.state_thermo rows) ---------------------------
  const double T = AT(st, 0), logT = AT(st, 1), pres = AT(st, 2);
  const double rho = AT(st, 3), mw_avg = AT(st, 4);
  const double* conc = st + (size_t)5 * B;
  const double* smh = st + (size_t)(5 + N) * B;
  const double* dsmh = st + (size_t)(5 + 2 * N) * B;
  const double dlnrho_dT = conp ? -1.0 / T : 0.0;
  const double dlnP_dT = conp ? 0.0 : 1.0 / T;

  // --- forward rate constant and its log-derivatives ----------------------
  const double beta = t.beta[r], Ta = t.Ta[r];
  const double kf_main = exp(t.logA[r] + beta * logT - Ta / T);
  double kf = kf_main * t.A_sign[r];
  const double dln_main = (beta + Ta / T) / T;
  double dlnkf = dln_main, aP = 0.0;

  const int pp = t.plog_pos[r];
  if (pp >= 0) {
    const int Pm = d.Pm;
    const double* lnPk = t.plog_lnP + (size_t)pp * Pm;
    const double lnP = log(pres);
    int cnt = 0;
    for (int k = 0; k < Pm; ++k) cnt += lnP > lnPk[k];
    const int n = t.plog_n[pp];
    const int ilo = min(max(cnt - 1, 0), max(n - 2, 0));
    const int ihi = min(ilo + 1, n - 1);
    const double* pA = t.plog_logA + (size_t)pp * Pm;
    const double* pb = t.plog_beta + (size_t)pp * Pm;
    const double* pT = t.plog_Ta + (size_t)pp * Pm;
    const double lo = pA[ilo] + pb[ilo] * logT - pT[ilo] / T;
    const double hi = pA[ihi] + pb[ihi] * logT - pT[ihi] / T;
    const double dlo = (pb[ilo] + pT[ilo] / T) / T;
    const double dhi = (pb[ihi] + pT[ihi] / T) / T;
    const double denom = lnPk[ihi] - lnPk[ilo];
    const double safe = denom == 0.0 ? 1.0 : denom;
    const double w_raw = (lnP - lnPk[ilo]) / safe;
    const double w = fmin(fmax(w_raw, 0.0), 1.0);
    const bool interior = w_raw > 0.0 && w_raw < 1.0 && denom != 0.0;
    kf = exp(lo + (hi - lo) * w);
    dlnkf = dlo + (dhi - dlo) * w;
    aP = interior ? (hi - lo) / safe : 0.0;
  }
  const int cp_ = t.cheb_pos[r];
  if (cp_ >= 0) {
    const int NT = d.NT, NP = d.NP;
    const double* tl = t.cheb_tlim + 2 * cp_;
    const double* pl = t.cheb_plim + 2 * cp_;
    const double Tred = (2.0 / T - tl[0]) / tl[1];
    const double Pred = (2.0 * log10(fmax(pres, TINY)) - pl[0]) / pl[1];
    double Tp[MAX_CHEB], dTp[MAX_CHEB], Pp[MAX_CHEB], dPp[MAX_CHEB];
    Tp[0] = 1.0; dTp[0] = 0.0; Pp[0] = 1.0; dPp[0] = 0.0;
    if (NT > 1) { Tp[1] = Tred; dTp[1] = 1.0; }
    if (NP > 1) { Pp[1] = Pred; dPp[1] = 1.0; }
    for (int i = 2; i < NT; ++i) {
      dTp[i] = 2.0 * Tp[i - 1] + 2.0 * Tred * dTp[i - 1] - dTp[i - 2];
      Tp[i] = 2.0 * Tred * Tp[i - 1] - Tp[i - 2];
    }
    for (int i = 2; i < NP; ++i) {
      dPp[i] = 2.0 * Pp[i - 1] + 2.0 * Pred * dPp[i - 1] - dPp[i - 2];
      Pp[i] = 2.0 * Pred * Pp[i - 1] - Pp[i - 2];
    }
    const double* coef = t.cheb_coef + (size_t)cp_ * NT * NP;
    double lgk = 0.0, dlgk_T = 0.0, dlgk_P = 0.0;
    for (int i = 0; i < NT; ++i) {
      double sk = 0.0, sdP = 0.0;
      for (int j = 0; j < NP; ++j) {
        sk += coef[i * NP + j] * Pp[j];
        sdP += coef[i * NP + j] * dPp[j];
      }
      lgk += Tp[i] * sk;
      dlgk_T += dTp[i] * sk;
      dlgk_P += Tp[i] * sdP;
    }
    const double dTred_dT = (-2.0 / (T * T)) / tl[1];
    const double dPred_dlnP = 2.0 / (LN10 * pl[1]);
    kf = exp(LN10 * lgk);
    dlnkf = LN10 * dlgk_T * dTred_dT;
    aP = LN10 * dlgk_P * dPred_dlnP;
  }

  // --- reverse rate constant ------------------------------------------------
  double kr = 0.0, dlnkr = 0.0;
  if (fl & F_REV) {
    double lnKc = 0.0, dlnKc = 0.0;
    for (int e = t.nu_ptr[r]; e < t.nu_ptr[r + 1]; ++e) {
      lnKc += t.nu_val[e] * AT(smh, t.nu_col[e]);
      dlnKc += t.nu_val[e] * AT(dsmh, t.nu_col[e]);
    }
    lnKc = lnKc + t.sum_nu[r] * (d.ln_pa_ru - logT);
    dlnKc = dlnKc - t.sum_nu[r] / T;
    kr = kf * exp(-lnKc);
    dlnkr = dlnkf - dlnKc;
  }

  // --- rates of progress and slot derivatives ---------------------------------
  double pwf[MAX_SLOTS], pwp[MAX_SLOTS], dpf[MAX_SLOTS], dpr[MAX_SLOTS];
  const int* rsp = t.reac_sp + (size_t)r * Sf;
  const int* psp = t.prod_sp + (size_t)r * Sp;
  const double pf = slot_products(conc, B, b, Sf, rsp, t.reac_nu + (size_t)r * Sf,
                                  d.has_frac, pwf, dpf);
  const double pr = slot_products(conc, B, b, Sp, psp, t.prod_nu + (size_t)r * Sp,
                                  d.has_frac, pwp, dpr);
  const double Rf = kf * pf;
  const double Rr = kr * pr;
  const double ordf = t.ordf[r], ordr = t.ordr[r];

  // --- pressure modification ----------------------------------------------------
  double pm = 1.0, dpm = 0.0, cupm = 0.0, psi = 0.0, xi = 0.0;
  if (HAS_PM && (fl & (F_THD | F_FALL | F_CHEM))) {
    const double m_tb = pres / (RU * T);
    double esum = 0.0;
    for (int e = t.thd_ptr[r]; e < t.thd_ptr[r + 1]; ++e)
      esum += AT(conc, t.thd_col[e]) * t.thd_val[e];
    const double thd = m_tb + esum;
    if (fl & F_THD) {
      pm = thd;
      if (conp) {
        dpm = -thd / T;
        cupm = -mw_avg * (thd - m_tb);
      } else {
        cupm = rho;
      }
      psi = rho;
    } else {
      const bool fall = fl & F_FALL, chem = fl & F_CHEM;
      const double k0 = fall ? exp(t.low_logA[r] + t.low_beta[r] * logT -
                                   t.low_Ta[r] / T)
                             : kf_main;
      const double dlnk0 = fall ? (t.low_beta[r] + t.low_Ta[r] / T) / T
                                : dln_main;
      const double kinf = chem ? exp(t.high_logA[r] + t.high_beta[r] * logT -
                                     t.high_Ta[r] / T)
                               : kf_main;
      const double dlnkinf = chem ? (t.high_beta[r] + t.high_Ta[r] / T) / T
                                  : dln_main;
      const int pdi = t.pd[r];
      const bool spec = pdi >= 0;
      const double X = spec ? AT(conc, pdi) : thd;
      const double ratio = k0 / kinf;
      const double Pr = ratio * X;
      double F = 1.0, dFdT = 0.0, dFdL = 0.0;
      const double L = log10(fmax(Pr, TINY));
      const double dL = Pr > TINY ? 1.0 / (LN10 * fmax(Pr, TINY)) : 0.0;
      if (fl & F_TROE) {
        const double* tp = t.troe_par + 4 * r;
        const double a = tp[0], T3 = tp[1], T1 = tp[2], T2 = tp[3];
        const double e3 = exp(-T / T3);
        const double e1 = exp(-T / T1);
        double Fcent = (1.0 - a) * e3 + a * e1;
        double dFc = -(1.0 - a) / T3 * e3 - a / T1 * e1;
        if (fl & F_T2) {
          const double e2 = exp(-T2 / T);
          Fcent = Fcent + e2;
          dFc = dFc + T2 / (T * T) * e2;
        }
        const double c = log10(fmax(Fcent, TINY));
        const double dc = Fcent > TINY ? dFc / (LN10 * fmax(Fcent, TINY))
                                       : 0.0;
        const double A_ = L - 0.67 * c - 0.4;
        const double B_ = 0.806 - 1.1762 * c - 0.14 * L;
        const double AB = A_ / B_;
        const double g = 1.0 / (1.0 + AB * AB);
        const double Ft = exp(LN10 * c * g);
        const double dg_dc = -g * g * 2.0 * AB *
                             ((-0.67) * B_ - A_ * (-1.1762)) / (B_ * B_);
        const double dg_dL = -g * g * 2.0 * AB * (B_ - A_ * (-0.14)) /
                             (B_ * B_);
        F = Ft;
        dFdT = Ft * LN10 * (g + c * dg_dc) * dc;
        dFdL = Ft * LN10 * c * dg_dL;
      }
      if (fl & F_SRI) {
        const double* sp = t.sri_par + 5 * r;
        const double a_s = sp[0], b_s = sp[1], c_s = sp[2], d_s = sp[3],
                     e_s = sp[4];
        const double eb = exp(-b_s / T);
        const double ec = exp(-T / c_s);
        const double base = fmax(a_s * eb + ec, TINY);
        const double Xs = 1.0 / (1.0 + L * L);
        const double Fs = pow(base, Xs) * d_s * pow(T, e_s);
        const double dbase = a_s * b_s / (T * T) * eb - ec / c_s;
        F = Fs;
        dFdT = Fs * (Xs * dbase / base + e_s / T);
        dFdL = Fs * log(base) * (-2.0 * L * Xs * Xs);
      }
      const double G = fall ? Pr / (1.0 + Pr) : 1.0 / (1.0 + Pr);
      const double dG = (fall ? 1.0 : -1.0) / ((1.0 + Pr) * (1.0 + Pr));
      const double Phi = F * dG + G * dFdL * dL;
      const double dPr = Pr * (dlnk0 - dlnkinf + (conp ? -1.0 / T : 0.0));
      pm = F * G;
      dpm = G * dFdT + Phi * dPr;
      const double cu_mix = conp ? -mw_avg * (thd - m_tb) : rho;
      const double cu_X = spec ? (conp ? X * (-mw_avg) : 0.0) : cu_mix;
      cupm = Phi * ratio * cu_X;
      if (spec) xi = Phi * ratio * rho;
      else psi = Phi * ratio * rho;
    }
  }

  // --- dq/dT, the rank-one coefficients, the role rows ---------------------------
  const double qnet = Rf - Rr;
  const double q = pm * qnet;
  const double dq_dT = pm * (Rf * dlnkf - Rr * dlnkr) +
                       pm * dlnrho_dT * (ordf * Rf - ordr * Rr) +
                       dpm * qnet + pm * qnet * aP * dlnP_dT;
  double c_u = conp ? pm * (ordf * Rf - ordr * Rr) * (-mw_avg) : 0.0;
  c_u = c_u + cupm * qnet;
  if (!conp) c_u = c_u + pm * qnet * aP * mw_avg;

  const double pmrho = pm * rho;
  double dlf = 0.0, dlr = 0.0;
  for (int s = 0; s < Sf; ++s) {
    const double kd = kf * dpf[s];
    if (rsp[s] == N - 1) dlf = dlf + kd;
    AT(roles, (size_t)s * R + r) = pmrho * kd;
  }
  for (int s = 0; s < Sp; ++s) {
    const double kd = kr * dpr[s];
    if (psp[s] == N - 1) dlr = dlr + kd;
    AT(roles, (size_t)(Sf + s) * R + r) = pmrho * kd;
  }
  const size_t k = (size_t)(Sf + Sp) * R + r;
  AT(roles, k) = q;
  AT(roles, k + R) = dq_dT;
  AT(roles, k + 2 * (size_t)R) = c_u;
  AT(roles, k + 3 * (size_t)R) = -pm * rho * t.inv_mw[N - 1] * (dlf - dlr);
  AT(roles, k + 4 * (size_t)R) = psi * qnet;
  AT(roles, k + 5 * (size_t)R) = xi * qnet;
}

extern "C" int pyjac_big_parts_n_tables(void) { return N_TABLES; }

// tables: N_TABLES device pointers in PartsTables order; dims: N_DIMS ints
// {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac}; rows [row0, row0 + rows) of
// roles (Sf + Sp + 6, R, B) are written, with the pressure-modification
// machinery when has_pm.  Returns the launch's cudaError_t (0 on
// success), or -1 on a table / dimension mismatch.
extern "C" int pyjac_big_parts(const void* const* tables, int n_tables,
                               const int* dims, int n_dims, double ln_pa_ru,
                               const double* st, long long B, int row0,
                               int rows, int has_pm, double* roles,
                               void* stream) {
  if (n_tables != N_TABLES || n_dims != N_DIMS) return -1;
  if (dims[2] > MAX_SLOTS || dims[3] > MAX_SLOTS || dims[5] > MAX_CHEB ||
      dims[6] > MAX_CHEB || rows <= 0 || row0 < 0 || row0 + rows > dims[1])
    return -1;
  const int threads = 128;
  const long long tiles = (B + threads - 1) / threads;
  if (tiles > 65535) return -1;
  PartsTables t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = row0; d.rows = rows;
  d.ln_pa_ru = ln_pa_ru;
  dim3 grid((unsigned)rows, (unsigned)tiles);
  if (has_pm)
    big_parts_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        t, d, st, B, roles);
  else
    big_parts_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        t, d, st, B, roles);
  return (int)cudaGetLastError();
}
