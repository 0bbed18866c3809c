// Device code shared by the kernels of pyjac_tpu_torch, float64, sm_90a.
//
// * species_thermo: the NASA-7 thermo of one species (K1, K4);
// * reaction_parts: the per-(reaction, state) body of the large-mechanism
//   parts kernel K5 (csrc/big_parts.cu), which the dense fused kernel K4
//   (csrc/dense_fused.cu) runs on every reaction of a state;
// * finish_column: one Jacobian column from a CSR contraction of its
//   operand rows and the column-finishing `post` rows (`_post_col`), the
//   body of the sparse column kernel K6 (csrc/big_cols_sparse.cu) and of
//   K4's column loop.
//
// Every line follows the operation order of the plain PyTorch versions
// (ops/jacobian.reaction_parts_at, ops/thermo.py,
// ops/jacobian_sparse.post_col_reference), and the kernels are built with
// -fmad=false, so kernel and plain version round alike.  All arrays are
// batch-minor (rows, B): row r of state b is arr[r * B + b].

#pragma once

#include <cuda_runtime.h>

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

// row r of a batch-minor (rows, B) array at state b
#define AT(arr, r) (arr)[(size_t)(r) * (size_t)B + (size_t)b]

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
#define N_PARTS_TABLES 38
static_assert(sizeof(PartsTables) == N_PARTS_TABLES * sizeof(void*),
              "PartsTables must be N_PARTS_TABLES pointers");

struct PartsDims {
  int N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, row0, rows;
  double ln_pa_ru;
};

__device__ __forceinline__ double ipow(double c, int k) {
  // c^k as repeated multiplication, left to right (the plain version's
  // unrolled integer powers)
  if (k <= 0) return 1.0;
  double acc = c;
  for (int i = 1; i < k; ++i) acc = acc * c;
  return acc;
}

// NASA-7 thermo of one species from its coefficient row a (the range of
// T already chosen) and RW = RU / W: cp (cv under CONV), h (u), smh,
// dsmh/dT and dcp/dT (ops/thermo.py)
__device__ __forceinline__ void species_thermo(const double* a, double RW,
                                               double T, double logT,
                                               int conp, double& cp,
                                               double& e, double& smh,
                                               double& dsmh, double& dcp) {
  const double cpR = a[0] + T * (a[1] + T * (a[2] + T * (a[3] + a[4] * T)));
  if (conp) {
    cp = RW * cpR;
    e = RW * (a[5] + T * (a[0] + T * (a[1] / 2.0 + T * (
             a[2] / 3.0 + T * (a[3] / 4.0 + a[4] / 5.0 * T)))));
  } else {
    cp = RW * (cpR - 1.0);
    e = RW * (a[5] + T * (a[0] - 1.0 + T * (a[1] / 2.0 + T * (
             a[2] / 3.0 + T * (a[3] / 4.0 + a[4] / 5.0 * T)))));
  }
  smh = a[0] * (logT - 1.0) + T * (a[1] / 2.0 + T * (
      a[2] / 6.0 + T * (a[3] / 12.0 + a[4] / 20.0 * T))) - a[5] / T + a[6];
  dsmh = a[0] / T + a[1] / 2.0 + T * (a[2] / 3.0 + T * (
      a[3] / 4.0 + a[4] / 5.0 * T)) + a[5] / (T * T);
  dcp = RW * (a[1] + T * (2.0 * a[2] + T * (3.0 * a[3] + 4.0 * a[4] * T)));
}

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

// Reaction r of state b (`_compute_reaction_parts` + `_pdep_falloff_vals`)
// from the (5 + 3N, B) state/thermo rows st = [T, ln T, P, rho, mw_avg,
// conc, smh, dsmh] (jacobian_big.state_thermo); writes row r of each
// role of roles (Sf + Sp + 6, R, B):
//   [vals_f_s; vals_p_s; q; dq_dT; c_u; c_1; psi_q; xi_q].
// HAS_PM = false drops the pressure-modification machinery.
template <bool HAS_PM>
__device__ __forceinline__ void reaction_parts(
    const PartsTables& t, const PartsDims& d, const double* __restrict__ st,
    long long B, long long b, int r, double* __restrict__ roles) {
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

// Jacobian column j + 1 of state b into col (N rows of a batch-minor
// array): row n's contraction sum over the CSR entries
// [ptr[n], ptr[n + 1]) of coef * operand[src row], the 1/W_j scale, the
// rank-one terms and the temperature row (`_post_col`), from the
// column-finishing rows post (jacobian_sparse.post_rows).  ptr is the
// column's N + 1 entries of the CSR row pointer.
__device__ __forceinline__ void finish_column(
    const int* __restrict__ ptr, const int* __restrict__ col_src,
    const double* __restrict__ col_coef, const double* __restrict__ inv_mw,
    const double* __restrict__ operand, const double* __restrict__ post,
    double* __restrict__ col, int j, int N, int conp, long long B,
    long long b) {
  const int J = N - 1;
  const double* v_u = post;
  const double* v_c = post + (size_t)N * B;
  const double* eWn = post + (size_t)2 * N * B;
  const double* cpr = post + (size_t)3 * N * B;
  const double* fkJ = post + (size_t)4 * N * B;
  const double* mr = post + (size_t)(4 * N + J) * B;
  const double ish = AT(post, 4 * N + 2 * J);
  const double mw_avg = AT(post, 4 * N + 2 * J + 1);
  const double fT = AT(post, 4 * N + 2 * J + 2);

  const double w_j = inv_mw[j];
  const double u_j = w_j - inv_mw[N - 1];
  const double r_j = conp ? -(mw_avg * u_j) : 0.0;
  double tsum = 0.0;
  for (int n = 0; n < N; ++n) {
    double acc = 0.0;
    for (int e = ptr[n]; e < ptr[n + 1]; ++e)
      acc += col_coef[e] * AT(operand, col_src[e]);
    const double dcol = acc * w_j + AT(v_u, n) * u_j + AT(v_c, n);
    tsum += AT(eWn, n) * dcol;
    if (n < J) AT(col, 1 + n) = AT(mr, n) * dcol - AT(fkJ, n) * r_j;
  }
  AT(col, 0) = -tsum - fT * (r_j + (AT(cpr, j) - AT(cpr, N - 1)) * ish);
}
