// Device code shared by the kernels of pyjac_tpu_torch, sm_90a, templated
// on the scalar type S: float64 for K1, K4, K5, K6 and K7, float32 for K3.
//
// * species_thermo: the NASA-7 thermo of one species (K1, K3, K4);
// * reaction_parts: the per-(reaction, state) body of the large-mechanism
//   parts kernel K5 (csrc/big_parts.cu), which the dense fused kernels K4
//   and K3 (csrc/dense_fused.cu) and the sparse stage-A kernel K1
//   (csrc/sparse_stage_a.cu) run on every reaction of a state;
// * state_phase, contract_phase, closure_*: the per-state phases of K1,
//   K4 and K3 around their reaction parts (thermo; nu_net^T contractions;
//   dy/dt, the temperature column and the column-finishing rows), the
//   closure in three parts that a block spreads over its threads (the
//   state tile that runs them: csrc/state_tile.cuh);
// * column_entry, column_temperature: one Jacobian column's species rows
//   from a CSR contraction of its operand rows and the column-finishing
//   `post` rows (`_post_col`), and its temperature row, which K4's and
//   K3's column phase spread over a block (finish_column runs a column on
//   one thread; the column kernels K6/K2x and K7 run a tiled counterpart,
//   csrc/columns.cuh).
//
// Every line follows the operation order of the plain PyTorch versions
// (ops/jacobian.reaction_parts_at, ops/thermo.py,
// ops/jacobian_sparse.post_col_reference), and the kernels are built with
// -fmad=false, so kernel and plain version round alike.  All arrays are
// batch-minor (rows, B): row r of state b is arr[r * B + b].
//
// Every table size runs: reaction_parts keeps the slot powers and the
// Chebyshev basis in per-thread arrays of ARRAY_SLOTS / ARRAY_CHEB values,
// and a mechanism with more slots or a higher Chebyshev order takes its
// wide path (WIDE_SLOTS), which recomputes them where they are read.
//
// Every constant goes through S (S(0.67), S(RU), Num<S>::tiny()): a
// double literal in a float expression would promote it to float64.  The
// float32 instantiation takes the guards of the TPU's f32 kernel
// (pyjac_tpu/ops/pallas_jacobian.py `_compute`): 1e-30 for 1e-300, and
// fractional powers as exp(nu log max(c, 1e-30)).

#pragma once

#include <cuda_runtime.h>

// the per-thread arrays of reaction_parts' slot and Chebyshev loops; a
// mechanism past either runs the wide path, SF = SP = WIDE_SLOTS
#define ARRAY_SLOTS 8
#define ARRAY_CHEB 16
#define WIDE_SLOTS (-1)

// whether a mechanism of Sf / Sp slots and an NT x NP Chebyshev table
// runs the wide path
inline bool wide_tables(int Sf, int Sp, int NT, int NP) {
  return Sf > ARRAY_SLOTS || Sp > ARRAY_SLOTS || NT > ARRAY_CHEB ||
         NP > ARRAY_CHEB;
}
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

// the math of one scalar type: the log floor, and the few functions whose
// float64 and float32 forms differ in more than their type
template <typename S>
struct Num;

template <>
struct Num<double> {
  static __device__ __forceinline__ double tiny() { return TINY; }
  // b^e for b > 0 (SRI)
  static __device__ __forceinline__ double pw(double b, double e) {
    return pow(b, e);
  }
  // c^nu and nu c^(nu - 1) of a fractional slot
  static __device__ __forceinline__ double frac_pow(double c, double nu) {
    return pow(c, nu);
  }
  static __device__ __forceinline__ double frac_dpow(double c, double nu) {
    return nu * pow(c, nu - 1.0);
  }
};

template <>
struct Num<float> {
  static __device__ __forceinline__ float tiny() { return 1.0e-30f; }
  static __device__ __forceinline__ float pw(float b, float e) {
    return expf(e * logf(b));
  }
  static __device__ __forceinline__ float frac_pow(float c, float nu) {
    return expf(nu * logf(fmaxf(c, tiny())));
  }
  static __device__ __forceinline__ float frac_dpow(float c, float nu) {
    return nu * expf((nu - 1.0f) * logf(fmaxf(c, tiny())));
  }
};

// exp / log / log10 / fmax / fmin of the argument's own type
__device__ __forceinline__ double kexp(double x) { return exp(x); }
__device__ __forceinline__ float kexp(float x) { return expf(x); }
__device__ __forceinline__ double klog(double x) { return log(x); }
__device__ __forceinline__ float klog(float x) { return logf(x); }
__device__ __forceinline__ double klog10(double x) { return log10(x); }
__device__ __forceinline__ float klog10(float x) { return log10f(x); }
__device__ __forceinline__ double kmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float kmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double kmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float kmin(float a, float b) { return fminf(a, b); }

// matches the numpy table order of jacobian_big.parts_tables
template <typename S>
struct PartsTables {
  const S *logA, *beta, *Ta, *A_sign, *sum_nu, *ordf, *ordr;
  const S *reac_nu, *prod_nu;
  const S *low_logA, *low_beta, *low_Ta, *high_logA, *high_beta, *high_Ta;
  const S *troe_par, *sri_par, *nu_val, *thd_val;
  const S *plog_lnP, *plog_logA, *plog_beta, *plog_Ta;
  const S *cheb_coef, *cheb_tlim, *cheb_plim, *inv_mw;
  const int *reac_sp, *prod_sp, *flags, *pd, *plog_pos, *cheb_pos, *plog_n;
  const int *nu_ptr, *nu_col, *thd_ptr, *thd_col;
};
#define N_PARTS_TABLES 38
static_assert(sizeof(PartsTables<double>) == N_PARTS_TABLES * sizeof(void*),
              "PartsTables must be N_PARTS_TABLES pointers");

template <typename S>
struct PartsDims {
  int N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, row0, rows;
  S ln_pa_ru;
};

template <typename S>
__device__ __forceinline__ S ipow(S c, int k) {
  // c^k as repeated multiplication, left to right (the plain version's
  // unrolled integer powers)
  if (k <= 0) return S(1);
  S acc = c;
  for (int i = 1; i < k; ++i) acc = acc * c;
  return acc;
}

// NASA-7 thermo of one species from its coefficient row a (the range of
// T already chosen) and RW = RU / W: cp (cv under CONV), h (u), smh,
// dsmh/dT and dcp/dT (ops/thermo.py)
template <typename S>
__device__ __forceinline__ void species_thermo(const S* a, S RW, S T, S logT,
                                               int conp, S& cp, S& e, S& smh,
                                               S& dsmh, S& dcp) {
  const S cpR = a[0] + T * (a[1] + T * (a[2] + T * (a[3] + a[4] * T)));
  if (conp) {
    cp = RW * cpR;
    e = RW * (a[5] + T * (a[0] + T * (a[1] / S(2) + T * (
             a[2] / S(3) + T * (a[3] / S(4) + a[4] / S(5) * T)))));
  } else {
    cp = RW * (cpR - S(1));
    e = RW * (a[5] + T * (a[0] - S(1) + T * (a[1] / S(2) + T * (
             a[2] / S(3) + T * (a[3] / S(4) + a[4] / S(5) * T)))));
  }
  smh = a[0] * (logT - S(1)) + T * (a[1] / S(2) + T * (
      a[2] / S(6) + T * (a[3] / S(12) + a[4] / S(20) * T))) - a[5] / T +
      a[6];
  dsmh = a[0] / T + a[1] / S(2) + T * (a[2] / S(3) + T * (
      a[3] / S(4) + a[4] / S(5) * T)) + a[5] / (T * T);
  dcp = RW * (a[1] + T * (S(2) * a[2] + T * (S(3) * a[3] +
                                             S(4) * a[4] * T)));
}

// concentration products of one side: powers, their product, and the
// slot derivatives d(prod)/dC_s (`_product_and_slot_derivs`); NS > 0
// fixes the side's slot count at compile time (then Sn == NS), so the
// loops unroll and pw / dp stay in registers
template <typename S, int NS = 0>
__device__ __forceinline__ S slot_products(const S* __restrict__ conc,
                                           long long B, long long b, int Sn,
                                           const int* sp, const S* nu,
                                           int has_frac, S* pw, S* dp) {
  if (NS) Sn = NS;
  S total = S(1);
  for (int s = 0; s < Sn; ++s) {
    const S c = AT(conc, sp[s]);
    if (nu[s] == S(0)) pw[s] = S(1);
    else pw[s] = has_frac ? Num<S>::frac_pow(c, nu[s]) : ipow(c, (int)nu[s]);
    total = s == 0 ? pw[0] : total * pw[s];
  }
  for (int s = 0; s < Sn; ++s) {
    const S c = AT(conc, sp[s]);
    S excl = S(1);
    for (int s2 = 0; s2 < Sn; ++s2)
      if (s2 != s) excl = excl * pw[s2];
    S dpow;
    if (nu[s] == S(0)) dpow = S(0);
    else if (has_frac) dpow = Num<S>::frac_dpow(c, nu[s]);
    else dpow = nu[s] * ipow(c, (int)nu[s] - 1);
    dp[s] = dpow * excl;
  }
  return total;
}

// one slot's concentration power c^nu and its derivative nu c^(nu - 1),
// as slot_products computes them.  slot_products keeps its own inline
// copy of this arithmetic on purpose: routed through these helpers, the
// array path compiles to other SASS (the flagship's K1 spills more and
// runs slower), while the inline copy keeps its code.
template <typename S>
__device__ __forceinline__ S slot_power(S c, S nu, int has_frac) {
  if (nu == S(0)) return S(1);
  return has_frac ? Num<S>::frac_pow(c, nu) : ipow(c, (int)nu);
}

template <typename S>
__device__ __forceinline__ S slot_dpower(S c, S nu, int has_frac) {
  if (nu == S(0)) return S(0);
  if (has_frac) return Num<S>::frac_dpow(c, nu);
  return nu * ipow(c, (int)nu - 1);
}

// The wide path's slot_products, without arrays: the product of a side
// (slot_product) and each slot derivative on demand (slot_deriv), the
// other slots' powers recomputed, O(Sn^2) powers a side.  Every value is
// slot_products', bit for bit: the same powers multiplied in the same
// order.
template <typename S>
__device__ __forceinline__ S slot_product(const S* __restrict__ conc,
                                          long long B, long long b, int Sn,
                                          const int* sp, const S* nu,
                                          int has_frac) {
  S total = S(1);
  for (int s = 0; s < Sn; ++s) {
    const S p = slot_power(AT(conc, sp[s]), nu[s], has_frac);
    total = s == 0 ? p : total * p;
  }
  return total;
}

template <typename S>
__device__ __forceinline__ S slot_deriv(const S* __restrict__ conc,
                                        long long B, long long b, int Sn,
                                        const int* sp, const S* nu,
                                        int has_frac, int s) {
  S excl = S(1);
  for (int s2 = 0; s2 < Sn; ++s2)
    if (s2 != s)
      excl = excl * slot_power(AT(conc, sp[s2]), nu[s2], has_frac);
  return slot_dpower(AT(conc, sp[s]), nu[s], has_frac) * excl;
}

// The wide path's Chebyshev sums, without the basis arrays: the T basis
// (with its derivative) carried through the loop over i, the P basis
// re-run for each i, O(NT NP) operations and no storage.  Each basis
// value comes from the array path's recurrence in its order, so the sums
// are the array path's, bit for bit.
template <typename S>
__device__ __forceinline__ void cheb_sums_streamed(const S* coef, int NT,
                                                   int NP, S Tred, S Pred,
                                                   S& lgk, S& dlgk_T,
                                                   S& dlgk_P) {
  S t1 = S(0), t2 = S(0), dt1 = S(0), dt2 = S(0);  // T_{i-1}, T_{i-2}
  for (int i = 0; i < NT; ++i) {
    S tp = S(1), dtp = S(0);
    if (i == 1) {
      tp = Tred;
      dtp = S(1);
    } else if (i > 1) {
      dtp = S(2) * t1 + S(2) * Tred * dt1 - dt2;
      tp = S(2) * Tred * t1 - t2;
    }
    S sk = S(0), sdP = S(0);
    S p1 = S(0), p2 = S(0), dp1 = S(0), dp2 = S(0);  // P_{j-1}, P_{j-2}
    for (int j = 0; j < NP; ++j) {
      S pp = S(1), dpp = S(0);
      if (j == 1) {
        pp = Pred;
        dpp = S(1);
      } else if (j > 1) {
        dpp = S(2) * p1 + S(2) * Pred * dp1 - dp2;
        pp = S(2) * Pred * p1 - p2;
      }
      sk += coef[i * NP + j] * pp;
      sdP += coef[i * NP + j] * dpp;
      p2 = p1; p1 = pp; dp2 = dp1; dp1 = dpp;
    }
    lgk += tp * sk;
    dlgk_T += dtp * sk;
    dlgk_P += tp * sdP;
    t2 = t1; t1 = tp; dt2 = dt1; dt1 = dtp;
  }
}

// A side's product (and, in the array layout, its powers pw and slot
// derivatives dp), and slot s's derivative: slot_products and dp[s] for
// NS >= 0, slot_product and slot_deriv for the wide path (NS = WIDE_SLOTS)
template <typename S, int NS>
__device__ __forceinline__ S side_product(const S* __restrict__ conc,
                                          long long B, long long b, int Sn,
                                          const int* sp, const S* nu,
                                          int has_frac, S* pw, S* dp) {
  if constexpr (NS == WIDE_SLOTS)
    return slot_product(conc, B, b, Sn, sp, nu, has_frac);
  else
    return slot_products<S, NS>(conc, B, b, Sn, sp, nu, has_frac, pw, dp);
}

template <typename S, int NS>
__device__ __forceinline__ S slot_dp(const S* dp, const S* __restrict__ conc,
                                     long long B, long long b, int Sn,
                                     const int* sp, const S* nu, int has_frac,
                                     int s) {
  if constexpr (NS == WIDE_SLOTS)
    return slot_deriv(conc, B, b, Sn, sp, nu, has_frac, s);
  else
    return dp[s];
}

// the six per-reaction roles after the slot roles of the role array
template <typename S>
struct ReactionRoles {
  S q, dq_dT, c_u, c_1, psi_q, xi_q;
};

// the six roles into rows k, k + R, ..., k + 5R of out: reaction r's rows
// of [q; dq_dT; c_u; c_1; psi_q; xi_q] when k is r plus those rows' first
// (without the xi_q row where with_xi is false: K4 / K3 keep none for a
// mechanism without species-specific pdep)
template <typename S>
__device__ __forceinline__ void store_roles(const ReactionRoles<S>& v,
                                            S* __restrict__ out, size_t k,
                                            int R, long long B, long long b,
                                            bool with_xi = true) {
  AT(out, k) = v.q;
  AT(out, k + R) = v.dq_dT;
  AT(out, k + 2 * (size_t)R) = v.c_u;
  AT(out, k + 3 * (size_t)R) = v.c_1;
  AT(out, k + 4 * (size_t)R) = v.psi_q;
  if (with_xi) AT(out, k + 5 * (size_t)R) = v.xi_q;
}

// Reaction r of state b (`_compute_reaction_parts` + `_pdep_falloff_vals`)
// from the (5 + 3N, B) state/thermo rows st = [T, ln T, P, rho, mw_avg,
// conc, smh, dsmh] (jacobian_big.state_thermo): the role array (Sf + Sp +
// 6, R, B) is [vals_f_s; vals_p_s; q; dq_dT; c_u; c_1; psi_q; xi_q]; this
// writes row r of the Sf + Sp slot roles at slots, at row stride oB and
// state ob, and returns the six others, which the caller stores (K5, K4
// and K3 after the slots, with store_roles; K1 on its tile, and psi_q and
// xi_q into its source stack, where the slot roles went too).  HAS_PM =
// false drops the pressure-modification machinery; SF > 0 (SP > 0) fixes
// the reactant (product) slot count at compile time, keeping the slot
// arrays in registers (K1, K4, K3 and K5 for Sf = Sp = 2); SF = SP =
// WIDE_SLOTS takes the counts of d and keeps no per-thread array (the
// wide path: a side of more than ARRAY_SLOTS slots or a Chebyshev order
// above ARRAY_CHEB), with the array path's results bit for bit.  Q_ONLY
// = true (the dy/dt kernel, csrc/dydt.cu) writes no slot role: of the
// six it returns the caller reads q alone, and the compiler drops the
// rest, so q is computed by the same lines in the same order.
template <typename S, bool HAS_PM, int SF = 0, int SP = 0, bool Q_ONLY = false>
__device__ __forceinline__ ReactionRoles<S> reaction_parts(
    const PartsTables<S>& t, const PartsDims<S>& d, const S* __restrict__ st,
    long long B, long long b, int r, S* __restrict__ slots, long long oB,
    long long ob) {
  constexpr bool WIDE = SF == WIDE_SLOTS;
  static_assert(WIDE == (SP == WIDE_SLOTS), "both sides wide or neither");
  const int N = d.N, R = d.R, conp = d.conp;
  const int Sf = SF > 0 ? SF : d.Sf, Sp = SP > 0 ? SP : d.Sp;
  const int fl = t.flags[r];
  const S tiny = Num<S>::tiny();

  // --- state (jacobian_big.state_thermo rows) ---------------------------
  const S T = AT(st, 0), logT = AT(st, 1), pres = AT(st, 2);
  const S rho = AT(st, 3), mw_avg = AT(st, 4);
  const S* conc = st + (size_t)5 * B;
  const S* smh = st + (size_t)(5 + N) * B;
  const S* dsmh = st + (size_t)(5 + 2 * N) * B;
  const S dlnrho_dT = conp ? -S(1) / T : S(0);
  const S dlnP_dT = conp ? S(0) : S(1) / T;

  // --- forward rate constant and its log-derivatives ----------------------
  const S beta = t.beta[r], Ta = t.Ta[r];
  const S kf_main = kexp(t.logA[r] + beta * logT - Ta / T);
  S kf = kf_main * t.A_sign[r];
  const S dln_main = (beta + Ta / T) / T;
  S dlnkf = dln_main, aP = S(0);

  const int pp = t.plog_pos[r];
  if (pp >= 0) {
    const int Pm = d.Pm;
    const S* lnPk = t.plog_lnP + (size_t)pp * Pm;
    const S lnP = klog(pres);
    int cnt = 0;
    for (int k = 0; k < Pm; ++k) cnt += lnP > lnPk[k];
    const int n = t.plog_n[pp];
    const int ilo = min(max(cnt - 1, 0), max(n - 2, 0));
    const int ihi = min(ilo + 1, n - 1);
    const S* pA = t.plog_logA + (size_t)pp * Pm;
    const S* pb = t.plog_beta + (size_t)pp * Pm;
    const S* pT = t.plog_Ta + (size_t)pp * Pm;
    const S lo = pA[ilo] + pb[ilo] * logT - pT[ilo] / T;
    const S hi = pA[ihi] + pb[ihi] * logT - pT[ihi] / T;
    const S dlo = (pb[ilo] + pT[ilo] / T) / T;
    const S dhi = (pb[ihi] + pT[ihi] / T) / T;
    const S denom = lnPk[ihi] - lnPk[ilo];
    const S safe = denom == S(0) ? S(1) : denom;
    const S w_raw = (lnP - lnPk[ilo]) / safe;
    const S w = kmin(kmax(w_raw, S(0)), S(1));
    const bool interior = w_raw > S(0) && w_raw < S(1) && denom != S(0);
    kf = kexp(lo + (hi - lo) * w);
    dlnkf = dlo + (dhi - dlo) * w;
    aP = interior ? (hi - lo) / safe : S(0);
  }
  const int cp_ = t.cheb_pos[r];
  if (cp_ >= 0) {
    const int NT = d.NT, NP = d.NP;
    const S* tl = t.cheb_tlim + 2 * cp_;
    const S* pl = t.cheb_plim + 2 * cp_;
    const S Tred = (S(2) / T - tl[0]) / tl[1];
    const S Pred = (S(2) * klog10(kmax(pres, tiny)) - pl[0]) / pl[1];
    constexpr int NC = WIDE ? 1 : ARRAY_CHEB;
    S Tp[NC], dTp[NC], Pp[NC], dPp[NC];
    if constexpr (!WIDE) {
      Tp[0] = S(1); dTp[0] = S(0); Pp[0] = S(1); dPp[0] = S(0);
      if (NT > 1) { Tp[1] = Tred; dTp[1] = S(1); }
      if (NP > 1) { Pp[1] = Pred; dPp[1] = S(1); }
      for (int i = 2; i < NT; ++i) {
        dTp[i] = S(2) * Tp[i - 1] + S(2) * Tred * dTp[i - 1] - dTp[i - 2];
        Tp[i] = S(2) * Tred * Tp[i - 1] - Tp[i - 2];
      }
      for (int i = 2; i < NP; ++i) {
        dPp[i] = S(2) * Pp[i - 1] + S(2) * Pred * dPp[i - 1] - dPp[i - 2];
        Pp[i] = S(2) * Pred * Pp[i - 1] - Pp[i - 2];
      }
    }
    const S* coef = t.cheb_coef + (size_t)cp_ * NT * NP;
    S lgk = S(0), dlgk_T = S(0), dlgk_P = S(0);
    if constexpr (WIDE)
      cheb_sums_streamed(coef, NT, NP, Tred, Pred, lgk, dlgk_T, dlgk_P);
    else
      for (int i = 0; i < NT; ++i) {
        S sk = S(0), sdP = S(0);
        for (int j = 0; j < NP; ++j) {
          sk += coef[i * NP + j] * Pp[j];
          sdP += coef[i * NP + j] * dPp[j];
        }
        lgk += Tp[i] * sk;
        dlgk_T += dTp[i] * sk;
        dlgk_P += Tp[i] * sdP;
      }
    const S dTred_dT = (-S(2) / (T * T)) / tl[1];
    const S dPred_dlnP = S(2) / (S(LN10) * pl[1]);
    kf = kexp(S(LN10) * lgk);
    dlnkf = S(LN10) * dlgk_T * dTred_dT;
    aP = S(LN10) * dlgk_P * dPred_dlnP;
  }

  // --- reverse rate constant ------------------------------------------------
  S kr = S(0), dlnkr = S(0);
  if (fl & F_REV) {
    S lnKc = S(0), dlnKc = S(0);
    for (int e = t.nu_ptr[r]; e < t.nu_ptr[r + 1]; ++e) {
      lnKc += t.nu_val[e] * AT(smh, t.nu_col[e]);
      dlnKc += t.nu_val[e] * AT(dsmh, t.nu_col[e]);
    }
    lnKc = lnKc + t.sum_nu[r] * (d.ln_pa_ru - logT);
    dlnKc = dlnKc - t.sum_nu[r] / T;
    kr = kf * kexp(-lnKc);
    dlnkr = dlnkf - dlnKc;
  }

  // --- rates of progress and slot derivatives ---------------------------------
  // (the wide path keeps no slot array: side_product and slot_dp below)
  constexpr int NA = WIDE ? 1 : ARRAY_SLOTS;
  S pwf[NA], pwp[NA], dpf[NA], dpr[NA];
  const int* rsp = t.reac_sp + (size_t)r * Sf;
  const int* psp = t.prod_sp + (size_t)r * Sp;
  const S pf = side_product<S, SF>(conc, B, b, Sf, rsp,
                                   t.reac_nu + (size_t)r * Sf, d.has_frac,
                                   pwf, dpf);
  const S pr = side_product<S, SP>(conc, B, b, Sp, psp,
                                   t.prod_nu + (size_t)r * Sp, d.has_frac,
                                   pwp, dpr);
  const S Rf = kf * pf;
  const S Rr = kr * pr;
  const S ordf = t.ordf[r], ordr = t.ordr[r];

  // --- pressure modification ----------------------------------------------------
  S pm = S(1), dpm = S(0), cupm = S(0), psi = S(0), xi = S(0);
  if (HAS_PM && (fl & (F_THD | F_FALL | F_CHEM))) {
    const S m_tb = pres / (S(RU) * T);
    S esum = S(0);
    for (int e = t.thd_ptr[r]; e < t.thd_ptr[r + 1]; ++e)
      esum += AT(conc, t.thd_col[e]) * t.thd_val[e];
    const S thd = m_tb + esum;
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
      const S k0 = fall ? kexp(t.low_logA[r] + t.low_beta[r] * logT -
                               t.low_Ta[r] / T)
                        : kf_main;
      const S dlnk0 = fall ? (t.low_beta[r] + t.low_Ta[r] / T) / T
                           : dln_main;
      const S kinf = chem ? kexp(t.high_logA[r] + t.high_beta[r] * logT -
                                 t.high_Ta[r] / T)
                          : kf_main;
      const S dlnkinf = chem ? (t.high_beta[r] + t.high_Ta[r] / T) / T
                             : dln_main;
      const int pdi = t.pd[r];
      const bool spec = pdi >= 0;
      const S X = spec ? AT(conc, pdi) : thd;
      const S ratio = k0 / kinf;
      const S Pr = ratio * X;
      S F = S(1), dFdT = S(0), dFdL = S(0);
      const S L = klog10(kmax(Pr, tiny));
      const S dL = Pr > tiny ? S(1) / (S(LN10) * kmax(Pr, tiny)) : S(0);
      if (fl & F_TROE) {
        const S* tp = t.troe_par + 4 * r;
        const S a = tp[0], T3 = tp[1], T1 = tp[2], T2 = tp[3];
        const S e3 = kexp(-T / T3);
        const S e1 = kexp(-T / T1);
        S Fcent = (S(1) - a) * e3 + a * e1;
        S dFc = -(S(1) - a) / T3 * e3 - a / T1 * e1;
        if (fl & F_T2) {
          const S e2 = kexp(-T2 / T);
          Fcent = Fcent + e2;
          dFc = dFc + T2 / (T * T) * e2;
        }
        const S c = klog10(kmax(Fcent, tiny));
        const S dc = Fcent > tiny ? dFc / (S(LN10) * kmax(Fcent, tiny))
                                  : S(0);
        const S A_ = L - S(0.67) * c - S(0.4);
        const S B_ = S(0.806) - S(1.1762) * c - S(0.14) * L;
        const S AB = A_ / B_;
        const S g = S(1) / (S(1) + AB * AB);
        const S Ft = kexp(S(LN10) * c * g);
        const S dg_dc = -g * g * S(2) * AB *
                        ((-S(0.67)) * B_ - A_ * (-S(1.1762))) / (B_ * B_);
        const S dg_dL = -g * g * S(2) * AB * (B_ - A_ * (-S(0.14))) /
                        (B_ * B_);
        F = Ft;
        dFdT = Ft * S(LN10) * (g + c * dg_dc) * dc;
        dFdL = Ft * S(LN10) * c * dg_dL;
      }
      if (fl & F_SRI) {
        const S* sp = t.sri_par + 5 * r;
        const S a_s = sp[0], b_s = sp[1], c_s = sp[2], d_s = sp[3],
                e_s = sp[4];
        const S eb = kexp(-b_s / T);
        const S ec = kexp(-T / c_s);
        const S base = kmax(a_s * eb + ec, tiny);
        const S Xs = S(1) / (S(1) + L * L);
        const S Fs = Num<S>::pw(base, Xs) * d_s * Num<S>::pw(T, e_s);
        const S dbase = a_s * b_s / (T * T) * eb - ec / c_s;
        F = Fs;
        dFdT = Fs * (Xs * dbase / base + e_s / T);
        dFdL = Fs * klog(base) * (-S(2) * L * Xs * Xs);
      }
      const S G = fall ? Pr / (S(1) + Pr) : S(1) / (S(1) + Pr);
      const S dG = (fall ? S(1) : -S(1)) / ((S(1) + Pr) * (S(1) + Pr));
      const S Phi = F * dG + G * dFdL * dL;
      const S dPr = Pr * (dlnk0 - dlnkinf + (conp ? -S(1) / T : S(0)));
      pm = F * G;
      dpm = G * dFdT + Phi * dPr;
      const S cu_mix = conp ? -mw_avg * (thd - m_tb) : rho;
      const S cu_X = spec ? (conp ? X * (-mw_avg) : S(0)) : cu_mix;
      cupm = Phi * ratio * cu_X;
      if (spec) xi = Phi * ratio * rho;
      else psi = Phi * ratio * rho;
    }
  }

  // --- dq/dT, the rank-one coefficients, the role rows ---------------------------
  const S qnet = Rf - Rr;
  const S q = pm * qnet;
  const S dq_dT = pm * (Rf * dlnkf - Rr * dlnkr) +
                  pm * dlnrho_dT * (ordf * Rf - ordr * Rr) +
                  dpm * qnet + pm * qnet * aP * dlnP_dT;
  S c_u = conp ? pm * (ordf * Rf - ordr * Rr) * (-mw_avg) : S(0);
  c_u = c_u + cupm * qnet;
  if (!conp) c_u = c_u + pm * qnet * aP * mw_avg;

  const S pmrho = pm * rho;
  S dlf = S(0), dlr = S(0);
  if constexpr (!Q_ONLY) {
    for (int s = 0; s < Sf; ++s) {
      const S kd = kf * slot_dp<S, SF>(dpf, conc, B, b, Sf, rsp,
                                       t.reac_nu + (size_t)r * Sf, d.has_frac,
                                       s);
      if (rsp[s] == N - 1) dlf = dlf + kd;
      slots[((size_t)s * R + r) * oB + ob] = pmrho * kd;
    }
    for (int s = 0; s < Sp; ++s) {
      const S kd = kr * slot_dp<S, SP>(dpr, conc, B, b, Sp, psp,
                                       t.prod_nu + (size_t)r * Sp, d.has_frac,
                                       s);
      if (psp[s] == N - 1) dlr = dlr + kd;
      slots[((size_t)(Sf + s) * R + r) * oB + ob] = pmrho * kd;
    }
  }
  return {q, dq_dT, c_u, -pm * rho * t.inv_mw[N - 1] * (dlf - dlr),
          psi * qnet, xi * qnet};
}

// ---------------------------------------------------------------------------
// The per-state phases around the reaction parts that K1
// (csrc/sparse_stage_a.cu) and K4 / K3 (csrc/dense_fused.cu) share: the
// state and thermo before them, the stoichiometric contractions and the
// closure (`_finish_dd`) after them.  The kernels run them on a tile of
// states (csrc/state_tile.cuh), called with (B, b) = (the tile's width,
// the state's column in it); W thread groups share a state, group w
// taking species w, w + W, ...; a __syncthreads() separates two phases,
// each called for live states only.

// matches the numpy table order of jacobian_sparse.finish_tables; in K1's
// and K4's table structs it follows the PartsTables
template <typename S>
struct FinishTables {
  const S *mw, *T_mid, *a_lo, *a_hi, *at_last, *pd_last, *nut_val;
  const int *nut_ptr, *nut_row;
};
#define N_FINISH_TABLES 9
static_assert(sizeof(FinishTables<double>) == N_FINISH_TABLES * sizeof(void*),
              "FinishTables must be N_FINISH_TABLES pointers");

// the state scalars the closure needs
template <typename S>
struct StateScalars {
  S rho, mw_avg, yN, dlnrho_dT;
};

// 1. the state and the NASA-7 thermo (jacobian_big.state_thermo) of state
// b from y (N, B) and Pin (1, B) (pressure under CONP, density under
// CONV): the (5 + 3N) rows st that reaction_parts reads (warp 0 writes the
// five state rows), and per species cp (cv) into cpr, h (u) into hrow and
// dcp/dT into dcpr
template <typename S>
__device__ __forceinline__ StateScalars<S> state_phase(
    const PartsTables<S>& p, const FinishTables<S>& f, int N, int conp,
    const S* __restrict__ y, const S* __restrict__ Pin, long long B,
    long long b, int w, int W, S* __restrict__ st, S* __restrict__ cpr,
    S* __restrict__ hrow, S* __restrict__ dcpr) {
  const int J = N - 1;
  S* conc = st + (size_t)5 * B;
  S* smh = st + (size_t)(5 + N) * B;
  S* dsmh = st + (size_t)(5 + 2 * N) * B;
  StateScalars<S> s;
  const S T = AT(y, 0);
  const S Pv = AT(Pin, 0);
  S sumY = S(0), sumYw = S(0);
  for (int n = 0; n < J; ++n) {
    const S Yn = AT(y, 1 + n);
    sumY += Yn;
    sumYw += Yn * p.inv_mw[n];
  }
  s.yN = S(1) - sumY;
  s.mw_avg = S(1) / (sumYw + s.yN * p.inv_mw[N - 1]);
  S pres;
  if (conp) {
    pres = Pv;
    s.rho = pres * s.mw_avg / (S(RU) * T);
    s.dlnrho_dT = -S(1) / T;
  } else {
    s.rho = Pv;
    pres = s.rho * S(RU) * T / s.mw_avg;
    s.dlnrho_dT = S(0);
  }
  const S logT = klog(T);
  if (w == 0) {
    AT(st, 0) = T;
    AT(st, 1) = logT;
    AT(st, 2) = pres;
    AT(st, 3) = s.rho;
    AT(st, 4) = s.mw_avg;
  }
  for (int n = w; n < N; n += W) {
    const S Yn = n < J ? AT(y, 1 + n) : s.yN;
    AT(conc, n) = s.rho * Yn * p.inv_mw[n];
    const S* a = (T <= f.T_mid[n] ? f.a_lo : f.a_hi) + 7 * n;
    S cp, e, smh_n, dsmh_n, dcp;
    species_thermo(a, S(RU) * p.inv_mw[n], T, logT, conp, cp, e, smh_n,
                   dsmh_n, dcp);
    AT(smh, n) = smh_n;
    AT(dsmh, n) = dsmh_n;
    AT(cpr, n) = cp;
    AT(hrow, n) = e;
    AT(dcpr, n) = dcp;
  }
  return s;
}

// 3. the stoichiometric contractions nu_net^T [q, dq_dT, c_u, cv] of
// species n = w, w + W, ..., each walking its column of nu_net (a CSR over
// reactions) with the four sums in registers, from the six per-reaction
// rows rest (6 R, B) = [q; dq_dT; c_u; c_1; psi_q; xi_q]; cv = c_1 -
// psi_q at_last + xi_q pd_last.  Writes omega, domega and the post rows
// v_u, v_c.  Q_ONLY (the dy/dt kernel): rest holds the q row alone, and
// only omega is summed and written, in the same order.
template <typename S, bool HAS_PM, bool Q_ONLY = false>
__device__ __forceinline__ void contract_phase(
    const FinishTables<S>& f, int has_spec, int N, int R,
    const S* __restrict__ rest, long long B, long long b, int w, int W,
    S* __restrict__ omega, S* __restrict__ domega, S* __restrict__ v_u,
    S* __restrict__ v_c) {
  if constexpr (Q_ONLY) {
    for (int n = w; n < N; n += W) {
      S om = S(0);
      for (int e = f.nut_ptr[n]; e < f.nut_ptr[n + 1]; ++e)
        om += f.nut_val[e] * AT(rest, f.nut_row[e]);
      AT(omega, n) = om;
    }
    return;
  }
  for (int n = w; n < N; n += W) {
    S om = S(0), dom = S(0), vu = S(0), vc = S(0);
    for (int e = f.nut_ptr[n]; e < f.nut_ptr[n + 1]; ++e) {
      const int r = f.nut_row[e];
      const S nu = f.nut_val[e];
      S cv = AT(rest, 3 * (size_t)R + r);
      if (HAS_PM) {
        cv = cv - AT(rest, 4 * (size_t)R + r) * f.at_last[r];
        if (has_spec) cv = cv + AT(rest, 5 * (size_t)R + r) * f.pd_last[r];
      }
      om += nu * AT(rest, r);
      dom += nu * AT(rest, (size_t)R + r);
      vu += nu * AT(rest, 2 * (size_t)R + r);
      vc += nu * cv;
    }
    AT(omega, n) = om;
    AT(domega, n) = dom;
    AT(v_u, n) = vu;
    AT(v_c, n) = vc;
  }
}

// 4. the closure (`_finish_dd`): dy/dt f (N, B), the temperature column
// col0 (N, B) and the post rows eWn, fkJ, mr, ish, mw_avg, fT
// (jacobian_sparse.post_rows; phase 1 wrote cp, phase 3 v_u and v_c), in
// three parts that a tile spreads over its threads: (a) closure_sums, the two
// sums over the species, one state per thread; (b) closure_species, one
// species' rows of col0 and f and fkJ, mr; (c) closure_temperature, the
// temperature row's sums and eWn, one state per thread (itself each
// species' temperature_terms, summed in order, then temperature_row: K1
// computes the terms over its block and sums them on one thread).  col0
// and fout are written at row stride oB, state ob; everything else at
// (B, b).  The dy/dt kernel's closure (F_ONLY) writes f alone:
// closure_species its dY/dt row, temperature_term_f each species' term of
// dT/dt, which its tile sums in order.
template <typename S>
struct ClosureSums {
  S sh, dsh;
};

template <typename S>
__device__ __forceinline__ ClosureSums<S> closure_sums(
    int N, const S* __restrict__ y, const StateScalars<S>& s,
    const S* __restrict__ cpr, const S* __restrict__ dcpr, long long B,
    long long b) {
  const int J = N - 1;
  S sh = S(0), dsh = S(0);
  for (int n = 0; n < N; ++n) {
    const S Yn = n < J ? AT(y, 1 + n) : s.yN;
    sh += AT(cpr, n) * Yn;
    dsh += AT(dcpr, n) * Yn;
  }
  return {sh, dsh};
}

template <typename S, bool F_ONLY = false>
__device__ __forceinline__ void closure_species(
    const FinishTables<S>& f, int N, int n, const StateScalars<S>& s,
    const S* __restrict__ omega, const S* __restrict__ domega, long long B,
    long long b, S* __restrict__ post, S* __restrict__ col0,
    S* __restrict__ fout, long long oB, long long ob) {
  const int J = N - 1;
  const S rho_inv = S(1) / s.rho;
  const S fk = AT(omega, n) * f.mw[n] * rho_inv;
  if constexpr (F_ONLY) {
    fout[(size_t)(1 + n) * oB + ob] = fk;
    return;
  }
  col0[(size_t)(1 + n) * oB + ob] =
      f.mw[n] * rho_inv * AT(domega, n) - fk * s.dlnrho_dT;
  fout[(size_t)(1 + n) * oB + ob] = fk;
  AT(post, 4 * N + n) = fk;                               // fkJ
  AT(post, 4 * N + J + n) = f.mw[n] * rho_inv;            // mr
}

// species n's term of dT/dt, temperature_terms' fT by the same operations
// (h W / (rho sh), times omega), with no post row; denomT = rho sh
template <typename S>
__device__ __forceinline__ S temperature_term_f(
    const FinishTables<S>& f, int n, S denomT, const S* __restrict__ hrow,
    const S* __restrict__ omega, long long B, long long b) {
  return AT(hrow, n) * f.mw[n] / denomT * AT(omega, n);
}

// species n's terms of the temperature row's three sums (fT, and s1, s2
// of its column-0 entry), after storing its eWn; denomT = rho sh
template <typename S>
struct TemperatureTerms {
  S fT, s1, s2;
};

template <typename S>
__device__ __forceinline__ TemperatureTerms<S> temperature_terms(
    const FinishTables<S>& f, int N, int n, S denomT,
    const S* __restrict__ hrow, const S* __restrict__ omega,
    const S* __restrict__ domega, long long B, long long b,
    S* __restrict__ post) {
  const S om = AT(omega, n);
  const S ew = AT(hrow, n) * f.mw[n] / denomT;
  AT(post, 2 * N + n) = ew;                               // eWn
  return {ew * om, AT(post, 3 * N + n) * f.mw[n] * om / denomT,
          ew * AT(domega, n)};
}

// the temperature row from its sums: col0's and f's row 0, ish, mw_avg, fT
template <typename S>
__device__ __forceinline__ void temperature_row(
    int N, const StateScalars<S>& s, const ClosureSums<S>& c, S fT, S s1,
    S s2, long long B, long long b, S* __restrict__ post,
    S* __restrict__ col0, S* __restrict__ fout, long long ob) {
  const int J = N - 1;
  col0[ob] = -(s1 + s2) - fT * (s.dlnrho_dT + c.dsh / c.sh);
  fout[ob] = fT;
  AT(post, 4 * N + 2 * J) = S(1) / c.sh;
  AT(post, 4 * N + 2 * J + 1) = s.mw_avg;
  AT(post, 4 * N + 2 * J + 2) = fT;
}

template <typename S>
__device__ __forceinline__ void closure_temperature(
    const FinishTables<S>& f, int N, const StateScalars<S>& s,
    const ClosureSums<S>& c, const S* __restrict__ hrow,
    const S* __restrict__ omega, const S* __restrict__ domega, long long B,
    long long b, S* __restrict__ post, S* __restrict__ col0,
    S* __restrict__ fout, long long oB, long long ob) {
  const S denomT = s.rho * c.sh;
  S fT = S(0), s1 = S(0), s2 = S(0);
  for (int n = 0; n < N; ++n) {
    const TemperatureTerms<S> t =
        temperature_terms(f, N, n, denomT, hrow, omega, domega, B, b, post);
    fT -= t.fT;
    s1 += t.s1;
    s2 += t.s2;
  }
  temperature_row(N, s, c, fT, s1, s2, B, b, post, col0, fout, ob);
}

// Jacobian column j + 1 of state b (`_post_col`), from the CSR of its
// assembly operand x nu_net over the operand's rows and the
// column-finishing rows post (jacobian_sparse.post_rows), in two parts
// that K4 / K3 spread over a block: column_entry, one species row n (its
// CSR entries [e0, e1) of coef * operand[src row], the 1/W_j scale, the
// rank-one terms), which returns the row's term of the temperature row;
// column_temperature, that row from the terms' sum over n in order.
// finish_column runs both on one thread, ptr being the column's N + 1
// entries of the CSR row pointer.  The column's rows are written at row
// stride oB, state ob; everything else is read at (B, b).
template <typename S>
struct ColumnScales {
  S w, u, r;   // 1/W_j, 1/W_j - 1/W_N, the rank-one coefficient r_j
};

template <typename S>
__device__ __forceinline__ ColumnScales<S> column_scales(
    const S* __restrict__ inv_mw, const S* __restrict__ post, int j, int N,
    int conp, long long B, long long b) {
  const S w_j = inv_mw[j];
  const S u_j = w_j - inv_mw[N - 1];
  const S mw_avg = AT(post, 4 * N + 2 * (N - 1) + 1);
  return {w_j, u_j, conp ? -(mw_avg * u_j) : S(0)};
}

template <typename S>
__device__ __forceinline__ S column_entry(
    int e0, int e1, const int* __restrict__ col_src,
    const S* __restrict__ col_coef, const ColumnScales<S>& c,
    const S* __restrict__ operand, const S* __restrict__ post,
    S* __restrict__ col, int n, int N, long long B, long long b,
    long long oB, long long ob) {
  const int J = N - 1;
  S acc = S(0);
  for (int e = e0; e < e1; ++e)
    acc += col_coef[e] * AT(operand, col_src[e]);
  const S dcol = acc * c.w + AT(post, n) * c.u + AT(post, N + n);
  if (n < J)
    col[(size_t)(1 + n) * oB + ob] =
        AT(post, 4 * N + J + n) * dcol - AT(post, 4 * N + n) * c.r;
  return AT(post, 2 * N + n) * dcol;
}

template <typename S>
__device__ __forceinline__ void column_temperature(
    S tsum, const ColumnScales<S>& c, const S* __restrict__ post,
    S* __restrict__ col, int j, int N, long long B, long long b, long long ob) {
  const int J = N - 1;
  const S ish = AT(post, 4 * N + 2 * J);
  const S fT = AT(post, 4 * N + 2 * J + 2);
  col[ob] = -tsum - fT * (c.r + (AT(post, 3 * N + j) -
                                 AT(post, 3 * N + N - 1)) * ish);
}

template <typename S>
__device__ __forceinline__ void finish_column(
    const int* __restrict__ ptr, const int* __restrict__ col_src,
    const S* __restrict__ col_coef, const S* __restrict__ inv_mw,
    const S* __restrict__ operand, const S* __restrict__ post,
    S* __restrict__ col, int j, int N, int conp, long long B, long long b) {
  const ColumnScales<S> c = column_scales(inv_mw, post, j, N, conp, B, b);
  S tsum = S(0);
  for (int n = 0; n < N; ++n)
    tsum += column_entry(ptr[n], ptr[n + 1], col_src, col_coef, c, operand,
                         post, col, n, N, B, b, B, b);
  column_temperature(tsum, c, post, col, j, N, B, b, b);
}
