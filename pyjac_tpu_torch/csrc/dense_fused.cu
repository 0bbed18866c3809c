// Dense fused Jacobian + dy/dt: K4 in float64 and K3 in float32, sm_90a.
//
// K4 replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py `_kernel_dd`
// (launched from `PallasDDJacobian.call_tr`), K3 the TPU kernel
// pyjac_tpu/ops/pallas_jacobian.py `_kernel` (launched from
// `PallasJacobian.call_tr`): in one launch, from the (N, B) states y and
// the (1, B) pressure (CONP) or density (CONV) row, the whole Jacobian Jt
// (N, N, B) in the TPU kernels' [column, row, batch] layout (column 0 the
// temperature column) and dy/dt f (N, B): thermo, rates, pressure
// modification, the stoichiometric contractions and the thermodynamic
// closure (`_compute_dd` / `_compute`), then every column (the column's
// assembly operand contracted with nu_net^T, then `_post_col`).  It
// covers every category the K5 body covers: Arrhenius (negative A
// included), PLOG, Chebyshev, reversible via Kc, third-body, Lindemann /
// Troe / SRI falloff, chemically activated, species-specific pdep,
// fractional stoichiometry; CONP and CONV.  One kernel template serves
// both, instantiated on the scalar type: K3 is the float instantiation,
// every constant typed through it (csrc/kinetics.cuh), with the f32
// guards of `_compute`.  The plain PyTorch versions are `dense_reference`
// in pyjac_tpu_torch/ops/jacobian_dense.py (K4) and `f32_reference` in
// pyjac_tpu_torch/ops/jacobian_f32.py (K3).
//
// What bounds it on this card: bytes.  A state writes its N x N Jacobian
// (22 KB in f64 at the 53-species flagship: 736 MB at B = 32768, >= 0.22
// ms at 3.35 TB/s; 11 KB in f32: 2.9 GB at B = 262144, >= 0.88 ms)
// against ~2 flops per nonzero of the column operands (4553 per flagship
// state) plus a few thousand for the rates and the closure.  The
// per-state intermediates (role rows, post rows: ~35 KB per flagship
// state in f64) go through a batch-minor global scratch, which L2 holds
// only in part, so the scratch traffic is of the output's order.
//
// What the design does about it: a block owns 32 consecutive states and
// runs WARPS warps over them; lane = state, so every load and store of a
// warp covers 32 consecutive values and every table read is one address
// for the warp.  The phases split their work over the warps and meet at
// __syncthreads: (1) the state scalars and the NASA thermo of species
// n = w, w + WARPS, ...; (2) the reaction parts of reactions r = w, ...
// (`reaction_parts`, the K5 body of csrc/kinetics.cuh) into the role
// rows; (3) the stoichiometric contractions of species n = w, ..., each
// walking its column of nu_net (a CSR over reactions) with the four sums
// in registers; (4) the closure on warp 0: dy/dt, the temperature column
// and the post rows; (5) columns j = w, ... (`finish_column`, the K6
// body), each walking the nonzeros of its operand x nu_net as a CSR over
// (column, species row) with the row sum in a register, so every J entry
// is written once.  Nothing is read-modify-written and nothing needs
// atomics.  Against the plain versions the sums run in another order
// (the CSR walks instead of dense matmuls; the operand's roles are
// contracted one by one instead of being added per reaction first), so
// kernel and plain version agree to roundoff, not bit for bit.

#include "kinetics.cuh"

#include <cstring>

#define WARPS 4

// matches the numpy table order of jacobian_dense.fused_tables after the
// K5 tables (jacobian_big.parts_tables)
template <typename S>
struct DenseTables {
  PartsTables<S> p;
  const S *mw, *T_mid, *a_lo, *a_hi, *at_last, *pd_last, *nut_val,
      *col_coef;
  const int *nut_ptr, *nut_row, *col_ptr, *col_src;
};
#define N_TABLES (N_PARTS_TABLES + 12)
static_assert(sizeof(DenseTables<double>) == N_TABLES * sizeof(void*),
              "DenseTables must be N_TABLES pointers");
#define N_DIMS 11

// scratch rows: state/thermo rows (5 + 3N), roles ((Sf + Sp + 6) R), post
// rows (4N + 2J + 3), then h, dcp, omega, domega (N each)
static long long scratch_rows(int N, int R, int Sf, int Sp) {
  return (long long)(5 + 3 * N) + (long long)(Sf + Sp + 6) * R +
         (4 * N + 2 * (N - 1) + 3) + 4 * N;
}

template <typename S, bool HAS_PM>
__global__ void __launch_bounds__(32 * WARPS)
dense_fused_kernel(DenseTables<S> t, PartsDims<S> d, int has_spec,
                   const S* __restrict__ y, const S* __restrict__ Pin,
                   long long B, S* __restrict__ Jt, S* __restrict__ fout,
                   S* __restrict__ scratch) {
  const long long b = (long long)blockIdx.x * 32 + threadIdx.x;
  const int w = threadIdx.y;
  const bool live = b < B;
  const int N = d.N, R = d.R, J = N - 1, conp = d.conp;
  const int k = d.Sf + d.Sp;
  const PartsTables<S>& p = t.p;

  S* st = scratch;
  S* conc = st + (size_t)5 * B;
  S* smh = st + (size_t)(5 + N) * B;
  S* dsmh = st + (size_t)(5 + 2 * N) * B;
  S* roles = st + (size_t)(5 + 3 * N) * B;
  // post rows (jacobian_sparse.post_rows)
  S* post = roles + (size_t)(k + 6) * R * B;
  S* v_u = post;
  S* v_c = post + (size_t)N * B;
  S* eWn = post + (size_t)2 * N * B;
  S* cpr = post + (size_t)3 * N * B;
  S* fkJ = post + (size_t)4 * N * B;
  S* mr = post + (size_t)(4 * N + J) * B;
  S* hrow = post + (size_t)(4 * N + 2 * J + 3) * B;
  S* dcpr = hrow + (size_t)N * B;
  S* omega = hrow + (size_t)2 * N * B;
  S* domega = hrow + (size_t)3 * N * B;

  // --- 1. state and NASA-7 thermo (jacobian_big.state_thermo) -------------
  S T = S(0), rho = S(0), mw_avg = S(0), yN = S(0), dlnrho_dT = S(0);
  if (live) {
    T = AT(y, 0);
    const S Pv = AT(Pin, 0);
    S sumY = S(0), sumYw = S(0);
    for (int n = 0; n < J; ++n) {
      const S Yn = AT(y, 1 + n);
      sumY += Yn;
      sumYw += Yn * p.inv_mw[n];
    }
    yN = S(1) - sumY;
    mw_avg = S(1) / (sumYw + yN * p.inv_mw[N - 1]);
    S pres;
    if (conp) {
      pres = Pv;
      rho = pres * mw_avg / (S(RU) * T);
      dlnrho_dT = -S(1) / T;
    } else {
      rho = Pv;
      pres = rho * S(RU) * T / mw_avg;
    }
    const S logT = klog(T);
    if (w == 0) {
      AT(st, 0) = T;
      AT(st, 1) = logT;
      AT(st, 2) = pres;
      AT(st, 3) = rho;
      AT(st, 4) = mw_avg;
    }
    for (int n = w; n < N; n += WARPS) {
      const S Yn = n < J ? AT(y, 1 + n) : yN;
      AT(conc, n) = rho * Yn * p.inv_mw[n];
      const S* a = (T <= t.T_mid[n] ? t.a_lo : t.a_hi) + 7 * n;
      S cp, e, smh_n, dsmh_n, dcp;
      species_thermo(a, S(RU) * p.inv_mw[n], T, logT, conp, cp, e, smh_n,
                     dsmh_n, dcp);
      AT(smh, n) = smh_n;
      AT(dsmh, n) = dsmh_n;
      AT(cpr, n) = cp;
      AT(hrow, n) = e;
      AT(dcpr, n) = dcp;
    }
  }
  __syncthreads();

  // --- 2. reaction parts into the role rows ---------------------------------
  if (live)
    for (int r = w; r < R; r += WARPS)
      reaction_parts<S, HAS_PM>(p, d, st, B, b, r, roles);
  __syncthreads();

  // --- 3. stoichiometric contractions nu_net^T [q, dq_dT, c_u, cv] -----------
  if (live) {
    const size_t kq = (size_t)k * R;
    for (int n = w; n < N; n += WARPS) {
      S om = S(0), dom = S(0), vu = S(0), vc = S(0);
      for (int e = t.nut_ptr[n]; e < t.nut_ptr[n + 1]; ++e) {
        const int r = t.nut_row[e];
        const S nu = t.nut_val[e];
        S cv = AT(roles, kq + 3 * (size_t)R + r);
        if (HAS_PM) {
          cv = cv - AT(roles, kq + 4 * (size_t)R + r) * t.at_last[r];
          if (has_spec)
            cv = cv + AT(roles, kq + 5 * (size_t)R + r) * t.pd_last[r];
        }
        om += nu * AT(roles, kq + r);
        dom += nu * AT(roles, kq + (size_t)R + r);
        vu += nu * AT(roles, kq + 2 * (size_t)R + r);
        vc += nu * cv;
      }
      AT(omega, n) = om;
      AT(domega, n) = dom;
      AT(v_u, n) = vu;
      AT(v_c, n) = vc;
    }
  }
  __syncthreads();

  // --- 4. closure: dy/dt, the temperature column, the post rows ---------------
  if (live && w == 0) {
    S sh = S(0), dsh = S(0);
    for (int n = 0; n < N; ++n) {
      const S Yn = n < J ? AT(y, 1 + n) : yN;
      sh += AT(cpr, n) * Yn;
      dsh += AT(dcpr, n) * Yn;
    }
    const S rho_inv = S(1) / rho;
    const S denomT = rho * sh;
    S fT = S(0), s1 = S(0), s2 = S(0);
    for (int n = 0; n < N; ++n) {
      const S om = AT(omega, n);
      const S ew = AT(hrow, n) * t.mw[n] / denomT;
      AT(eWn, n) = ew;
      fT -= ew * om;
      s1 += AT(cpr, n) * t.mw[n] * om / denomT;
      s2 += ew * AT(domega, n);
    }
    AT(Jt, 0) = -(s1 + s2) - fT * (dlnrho_dT + dsh / sh);
    AT(fout, 0) = fT;
    for (int n = 0; n < J; ++n) {
      const S fk = AT(omega, n) * t.mw[n] * rho_inv;
      AT(Jt, 1 + n) = t.mw[n] * rho_inv * AT(domega, n) - fk * dlnrho_dT;
      AT(fout, 1 + n) = fk;
      AT(fkJ, n) = fk;
      AT(mr, n) = t.mw[n] * rho_inv;
    }
    AT(post, 4 * N + 2 * J) = S(1) / sh;
    AT(post, 4 * N + 2 * J + 1) = mw_avg;
    AT(post, 4 * N + 2 * J + 2) = fT;
  }
  __syncthreads();

  // --- 5. the columns 1..J ------------------------------------------------------
  if (live)
    for (int j = w; j < J; j += WARPS)
      finish_column(t.col_ptr + (size_t)j * N, t.col_src, t.col_coef,
                    p.inv_mw, roles, post, Jt + (size_t)(j + 1) * N * B, j,
                    N, conp, B, b);
}

extern "C" int pyjac_dense_fused_n_tables(void) { return N_TABLES; }

// rows of the (rows, B) scratch pyjac_dense_fused and pyjac_fused_f32
// need; dims as there
extern "C" long long pyjac_dense_fused_scratch_rows(const int* dims) {
  return scratch_rows(dims[0], dims[1], dims[2], dims[3]);
}

template <typename S>
static int launch(const void* const* tables, int n_tables, const int* dims,
                  int n_dims, double ln_pa_ru, const S* y, const S* P,
                  long long B, S* Jt, S* f, S* scratch, void* stream) {
  if (n_tables != N_TABLES || n_dims != N_DIMS) return -1;
  if (dims[0] < 2 || dims[2] > MAX_SLOTS || dims[3] > MAX_SLOTS ||
      dims[5] > MAX_CHEB || dims[6] > MAX_CHEB || B < 1)
    return -1;
  DenseTables<S> t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<S> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = (S)ln_pa_ru;
  const long long blocks = (B + 31) / 32;
  if (blocks > 2147483647LL) return -1;
  dim3 block(32, WARPS);
  if (dims[9])
    dense_fused_kernel<S, true><<<(unsigned)blocks, block, 0,
                                  (cudaStream_t)stream>>>(
        t, d, dims[10], y, P, B, Jt, f, scratch);
  else
    dense_fused_kernel<S, false><<<(unsigned)blocks, block, 0,
                                   (cudaStream_t)stream>>>(
        t, d, dims[10], y, P, B, Jt, f, scratch);
  return (int)cudaGetLastError();
}

// K4.  tables: N_TABLES device pointers in DenseTables order; dims: N_DIMS
// ints {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, has_pm, has_spec}; y
// (N, B), P (1, B); writes Jt (N, N, B) and f (N, B) through scratch
// (pyjac_dense_fused_scratch_rows(dims), B).  Returns the launch's
// cudaError_t (0 on success), or -1 on a table / dimension mismatch.
extern "C" int pyjac_dense_fused(const void* const* tables, int n_tables,
                                 const int* dims, int n_dims, double ln_pa_ru,
                                 const double* y, const double* P,
                                 long long B, double* Jt, double* f,
                                 double* scratch, void* stream) {
  return launch<double>(tables, n_tables, dims, n_dims, ln_pa_ru, y, P, B,
                        Jt, f, scratch, stream);
}

// K3: pyjac_dense_fused in float32 (float tables, states, outputs and
// scratch; ln_pa_ru is rounded to float on the host).
extern "C" int pyjac_fused_f32(const void* const* tables, int n_tables,
                               const int* dims, int n_dims, double ln_pa_ru,
                               const float* y, const float* P, long long B,
                               float* Jt, float* f, float* scratch,
                               void* stream) {
  return launch<float>(tables, n_tables, dims, n_dims, ln_pa_ru, y, P, B, Jt,
                       f, scratch, stream);
}
