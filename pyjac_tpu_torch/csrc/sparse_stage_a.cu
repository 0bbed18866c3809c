// Stage A of the compressed sparse Jacobian pipeline, float64, sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py `_kernel_dd_src`
// (launched from `PallasDDJacobianSparse.stage_a`): per state, NASA
// thermo, forward/reverse rates with their temperature derivatives,
// third-body / Lindemann / Troe pressure modification, the per-slot
// assembly values, dy/dt and the temperature column.  It writes the
// stacked per-reaction source array
//   [vals_f_s; vals_p_s; psi_q*effval_s; xi_q|0; zero row]   (n_src, B)
// plus col0 (N, B), f (N, B) and the nine column-finishing rows of
// `_postcol_stream_spec` packed into one post (4N + 2J + 3, B) array.
// Its plain PyTorch version is `stage_a_reference` in
// pyjac_tpu_torch/ops/jacobian_sparse.py.
//
// What bounds it on this card: by the counts, the writes of the source
// stack.  For the 53-species / 325-reaction flagship a state writes 1951
// source rows and ~330 other rows, about 18 KB in f64, against a few
// thousand f64 flops and ~2000 exp/log calls; at B = 131072 that is
// 2.4 GB of stores.  The per-species accumulators (omega, d omega/dT,
// v_u, v_c) are read-modify-written in global scratch once per nonzero
// of nu_net (~4 x 1100 per state), which adds cache traffic of the same
// order.  Measured on an H100 80GB HBM3 at 700 W, the kernel reaches
// ~9% of the memory roofline, so neither bound is reached yet; the
// likeliest limits are those scratch read-modify-writes, the slot
// arrays in local memory and occupancy at 96 registers (PERF.md).
//
// What the design does about it: one thread per state on a batch-minor
// (rows, B) layout, so every load and store of a warp covers 32
// consecutive doubles (coalesced) and every mechanism-table read is the
// same address for the whole warp (a broadcast).  Each thread owns its
// (N, B) scratch column, so no atomics are needed.  The dense
// stoichiometric contractions of the TPU kernel (nu^T q on the MXU)
// become loops over each reaction's CSR row of nu_net, and the falloff
// machinery runs only on the falloff rows.  Covered categories:
// Arrhenius (negative A included), reversible via Kc, plain third-body,
// Lindemann and Troe falloff (with and without T2), integer
// stoichiometry.  The Python wrapper refuses any other category.

#include "kinetics.cuh"

#include <cstring>

// matches the numpy table order of jacobian_sparse.stage_a_tables
struct StageATables {
  const double *mw, *inv_mw, *T_mid, *a_lo, *a_hi;
  const double *logA, *beta, *Ta, *A_sign, *sum_nu, *ordf, *ordr;
  const double *reac_nu, *prod_nu;
  const double *low_logA, *low_beta, *low_Ta;
  const double *troe_a, *troe_T3, *troe_T1, *troe_T2;
  const double *at_last, *eff_val, *nu_val, *thd_val;
  const int *reac_sp, *prod_sp, *rev, *kind, *troe_has_T2;
  const int *nu_ptr, *nu_col, *thd_ptr, *thd_col;
};
#define N_TABLES 34
static_assert(sizeof(StageATables) == N_TABLES * sizeof(void*),
              "StageATables must be N_TABLES pointers");

struct StageADims {
  int N, R, Sf, Sp, S_eff, conp, has_troe_T2;
  double ln_pa_ru;
};
#define N_DIMS 7

// kind codes (jacobian_sparse.KIND_*)
#define KIND_THD 1
#define KIND_TROE 3

__global__ void __launch_bounds__(128)
sparse_stage_a_kernel(StageATables t, StageADims d, const double* __restrict__ y,
                      const double* __restrict__ Pin, long long B,
                      double* __restrict__ src, double* __restrict__ col0,
                      double* __restrict__ fout, double* __restrict__ post,
                      double* __restrict__ scratch) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = d.N, R = d.R, J = N - 1, Sf = d.Sf, Sp = d.Sp;
  const int conp = d.conp;

  // post rows (jacobian_sparse.post_rows)
  double* v_u = post;
  double* v_c = post + (size_t)N * B;
  double* eWn = post + (size_t)2 * N * B;
  double* cpr = post + (size_t)3 * N * B;
  double* fkJ = post + (size_t)4 * N * B;
  double* mr = post + (size_t)(4 * N + J) * B;
  double* ish_r = post + (size_t)(4 * N + 2 * J) * B;
  double* mwavg_r = post + (size_t)(4 * N + 2 * J + 1) * B;
  double* fT_r = post + (size_t)(4 * N + 2 * J + 2) * B;
  // scratch rows
  double* conc = scratch;
  double* smh = scratch + (size_t)N * B;
  double* dsmh = scratch + (size_t)2 * N * B;
  double* hrow = scratch + (size_t)3 * N * B;
  double* dcpr = scratch + (size_t)4 * N * B;
  double* omega = scratch + (size_t)5 * N * B;
  double* domega = scratch + (size_t)6 * N * B;

  // --- state --------------------------------------------------------------
  const double T = AT(y, 0);
  const double Pv = AT(Pin, 0);
  double sumY = 0.0, sumYw = 0.0;
  for (int k = 0; k < J; ++k) {
    const double Yk = AT(y, 1 + k);
    sumY += Yk;
    sumYw += Yk * t.inv_mw[k];
  }
  const double yN = 1.0 - sumY;
  const double mw_avg = 1.0 / (sumYw + yN * t.inv_mw[N - 1]);
  double rho, pres, dlnrho_dT;
  if (conp) {
    pres = Pv;
    rho = pres * mw_avg / (RU * T);
    dlnrho_dT = -1.0 / T;
  } else {
    rho = Pv;
    pres = rho * RU * T / mw_avg;
    dlnrho_dT = 0.0;
  }
  const double logT = log(T);

  // --- NASA-7 thermo per species ------------------------------------------
  double sh = 0.0, dsh = 0.0;
  for (int n = 0; n < N; ++n) {
    const double Yn = n < J ? AT(y, 1 + n) : yN;
    AT(conc, n) = rho * Yn * t.inv_mw[n];
    const double* a = (T <= t.T_mid[n] ? t.a_lo : t.a_hi) + 7 * n;
    double cp, e, smh_n, dsmh_n, dcp;
    species_thermo(a, RU * t.inv_mw[n], T, logT, conp, cp, e, smh_n, dsmh_n,
                   dcp);
    AT(smh, n) = smh_n;
    AT(dsmh, n) = dsmh_n;
    AT(cpr, n) = cp;
    AT(hrow, n) = e;
    AT(dcpr, n) = dcp;
    sh += cp * Yn;
    dsh += dcp * Yn;
    AT(omega, n) = 0.0;
    AT(domega, n) = 0.0;
    AT(v_u, n) = 0.0;
    AT(v_c, n) = 0.0;
  }

  // --- per reaction ---------------------------------------------------------
  const double m_tb = pres / (RU * T);
  for (int r = 0; r < R; ++r) {
    const double beta = t.beta[r], Ta = t.Ta[r];
    const double kf_main = exp(t.logA[r] + beta * logT - Ta / T);
    const double kf = kf_main * t.A_sign[r];
    const double dlnkf = (beta + Ta / T) / T;
    double kr = 0.0, dlnkr = 0.0;
    if (t.rev[r]) {
      double lnKc = 0.0, dlnKc = 0.0;
      for (int e = t.nu_ptr[r]; e < t.nu_ptr[r + 1]; ++e) {
        lnKc += t.nu_val[e] * AT(smh, t.nu_col[e]);
        dlnKc += t.nu_val[e] * AT(dsmh, t.nu_col[e]);
      }
      lnKc += t.sum_nu[r] * (d.ln_pa_ru - logT);
      dlnKc -= t.sum_nu[r] / T;
      kr = kf * exp(-lnKc);
      dlnkr = dlnkf - dlnKc;
    }

    // concentration products and their slot derivatives
    double pwf[MAX_SLOTS], pwp[MAX_SLOTS];
    double pf = 1.0, pr = 1.0;
    for (int s = 0; s < Sf; ++s) {
      const double nu = t.reac_nu[r * Sf + s];
      pwf[s] = nu == 0.0 ? 1.0 : ipow(AT(conc, t.reac_sp[r * Sf + s]), (int)nu);
      pf = s == 0 ? pwf[0] : pf * pwf[s];
    }
    for (int s = 0; s < Sp; ++s) {
      const double nu = t.prod_nu[r * Sp + s];
      pwp[s] = nu == 0.0 ? 1.0 : ipow(AT(conc, t.prod_sp[r * Sp + s]), (int)nu);
      pr = s == 0 ? pwp[0] : pr * pwp[s];
    }
    const double Rf = kf * pf;
    const double Rr = kr * pr;
    const double qnet = Rf - Rr;

    // pressure modification
    double pm = 1.0, dpm = 0.0, cupm = 0.0, psi = 0.0;
    const int kind = t.kind[r];
    if (kind != 0) {
      double esum = 0.0;
      for (int e = t.thd_ptr[r]; e < t.thd_ptr[r + 1]; ++e)
        esum += t.thd_val[e] * AT(conc, t.thd_col[e]);
      const double thd = m_tb + esum;
      if (kind == KIND_THD) {
        pm = thd;
        if (conp) {
          dpm = -thd / T;
          cupm = -mw_avg * (thd - m_tb);
        } else {
          cupm = rho;
        }
        psi = rho;
      } else {
        const double k0 = exp(t.low_logA[r] + t.low_beta[r] * logT -
                              t.low_Ta[r] / T);
        const double dlnk0 = (t.low_beta[r] + t.low_Ta[r] / T) / T;
        const double kinf = kf_main;
        const double dlnkinf = dlnkf;
        const double ratio = k0 / kinf;
        const double Pr = ratio * thd;
        const double Pc = fmax(Pr, TINY);
        const double L = log10(Pc);
        const double dL = Pr > TINY ? 1.0 / (LN10 * Pc) : 0.0;
        double F = 1.0, dFdT = 0.0, dFdL = 0.0;
        if (kind == KIND_TROE) {
          const double a = t.troe_a[r], T3 = t.troe_T3[r], T1 = t.troe_T1[r];
          const double e3 = exp(-T / T3);
          const double e1 = exp(-T / T1);
          double Fcent = (1.0 - a) * e3 + a * e1;
          double dFc = -(1.0 - a) / T3 * e3 - a / T1 * e1;
          if (d.has_troe_T2) {
            const double T2 = t.troe_T2[r];
            const double e2 = exp(-T2 / T);
            if (t.troe_has_T2[r]) {
              Fcent = Fcent + e2;
              dFc = dFc + T2 / (T * T) * e2;
            }
          }
          const double Fcc = fmax(Fcent, TINY);
          const double c = log10(Fcc);
          const double dc = Fcent > TINY ? dFc / (LN10 * Fcc) : 0.0;
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
        const double G = Pr / (1.0 + Pr);
        const double dG = 1.0 / ((1.0 + Pr) * (1.0 + Pr));
        const double Phi = F * dG + G * dFdL * dL;
        const double dPr = Pr * (dlnk0 - dlnkinf + (conp ? -1.0 / T : 0.0));
        pm = F * G;
        dpm = G * dFdT + Phi * dPr;
        const double cu_mix = conp ? -mw_avg * (thd - m_tb) : rho;
        cupm = Phi * ratio * cu_mix;
        psi = Phi * ratio * rho;
      }
    }

    const double q = pm * qnet;
    const double dq_dT = pm * (Rf * dlnkf - Rr * dlnkr) +
                         pm * dlnrho_dT * (t.ordf[r] * Rf - t.ordr[r] * Rr) +
                         dpm * qnet;
    double c_u = conp ? pm * (t.ordf[r] * Rf - t.ordr[r] * Rr) * (-mw_avg)
                      : 0.0;
    c_u = c_u + cupm * qnet;

    // per-slot assembly values -> source rows; D[r, N-1] for c_1
    const double pmrho = pm * rho;
    double dlast = 0.0;
    for (int s = 0; s < Sf; ++s) {
      const double nu = t.reac_nu[r * Sf + s];
      double v = 0.0;
      if (nu != 0.0) {
        const int sp = t.reac_sp[r * Sf + s];
        const double dpow = nu * ipow(AT(conc, sp), (int)nu - 1);
        double excl = 1.0;
        for (int s2 = 0; s2 < Sf; ++s2)
          if (s2 != s) excl *= pwf[s2];
        const double kd = kf * (dpow * excl);
        if (sp == N - 1) dlast += kd;
        v = pmrho * kd;
      }
      AT(src, (size_t)s * R + r) = v;
    }
    for (int s = 0; s < Sp; ++s) {
      const double nu = t.prod_nu[r * Sp + s];
      double v = 0.0;
      if (nu != 0.0) {
        const int sp = t.prod_sp[r * Sp + s];
        const double dpow = nu * ipow(AT(conc, sp), (int)nu - 1);
        double excl = 1.0;
        for (int s2 = 0; s2 < Sp; ++s2)
          if (s2 != s) excl *= pwp[s2];
        const double kd = kr * (dpow * excl);
        if (sp == N - 1) dlast -= kd;
        v = pmrho * kd;
      }
      AT(src, (size_t)(Sf + s) * R + r) = v;
    }
    const double c_1 = -pm * rho * t.inv_mw[N - 1] * dlast;
    const double psi_q = psi * qnet;
    for (int s = 0; s < d.S_eff; ++s)
      AT(src, (size_t)(Sf + Sp + s) * R + r) = psi_q * t.eff_val[r * d.S_eff + s];
    AT(src, (size_t)(Sf + Sp + d.S_eff) * R + r) = 0.0;   // xi_q: no species pdep

    // stoichiometric contractions over reaction r's nonzeros of nu_net
    const double cv = c_1 - psi_q * t.at_last[r];
    for (int e = t.nu_ptr[r]; e < t.nu_ptr[r + 1]; ++e) {
      const int n = t.nu_col[e];
      const double nu = t.nu_val[e];
      AT(omega, n) += nu * q;
      AT(domega, n) += nu * dq_dT;
      AT(v_u, n) += nu * c_u;
      AT(v_c, n) += nu * cv;
    }
  }
  AT(src, (size_t)(Sf + Sp + d.S_eff + 1) * R) = 0.0;      // the zero row

  // --- thermodynamic closure: dy/dt, the temperature column, post rows -----
  const double rho_inv = 1.0 / rho;
  const double denomT = rho * sh;
  double fT = 0.0, s1 = 0.0, s2 = 0.0;
  for (int n = 0; n < N; ++n) {
    const double om = AT(omega, n);
    const double ew = AT(hrow, n) * t.mw[n] / denomT;
    AT(eWn, n) = ew;
    fT -= ew * om;
    s1 += AT(cpr, n) * t.mw[n] * om / denomT;
    s2 += ew * AT(domega, n);
  }
  const double JTT = -(s1 + s2) - fT * (dlnrho_dT + dsh / sh);
  AT(col0, 0) = JTT;
  AT(fout, 0) = fT;
  for (int k = 0; k < J; ++k) {
    const double fk = AT(omega, k) * t.mw[k] * rho_inv;
    AT(col0, 1 + k) = t.mw[k] * rho_inv * AT(domega, k) - fk * dlnrho_dT;
    AT(fout, 1 + k) = fk;
    AT(fkJ, k) = fk;
    AT(mr, k) = t.mw[k] * rho_inv;
  }
  AT(ish_r, 0) = 1.0 / sh;
  AT(mwavg_r, 0) = mw_avg;
  AT(fT_r, 0) = fT;
}

extern "C" int pyjac_stage_a_n_tables(void) { return N_TABLES; }

// tables: N_TABLES device pointers in StageATables order; dims: N_DIMS
// ints {N, R, Sf, Sp, S_eff, conp, has_troe_T2}.
// Returns the launch's cudaError_t (0 on success), or -1 on a table or
// dimension count mismatch.
extern "C" int pyjac_stage_a(const void* const* tables, int n_tables,
                             const int* dims, int n_dims, double ln_pa_ru,
                             const double* y, const double* P, long long B,
                             double* src, double* col0, double* f,
                             double* post, double* scratch, void* stream) {
  if (n_tables != N_TABLES || n_dims != N_DIMS) return -1;
  if (dims[2] > MAX_SLOTS || dims[3] > MAX_SLOTS) return -1;
  StageATables t;
  std::memcpy(&t, tables, sizeof(t));
  StageADims d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.S_eff = dims[4]; d.conp = dims[5]; d.has_troe_T2 = dims[6];
  d.ln_pa_ru = ln_pa_ru;
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  sparse_stage_a_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(t, d, y, P, B, src, col0,
                                                  f, post, scratch);
  return (int)cudaGetLastError();
}
