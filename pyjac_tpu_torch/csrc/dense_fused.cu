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
// and the post rows (phases 1, 3 and 4 are csrc/kinetics.cuh's
// state_phase, contract_phase and closure, which K1 runs too); (5)
// columns j = w, ... (`finish_column`, the K6
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

// matches the numpy table order of jacobian_dense.fused_tables (the
// closure's jacobian_sparse.finish_tables, then the column CSR) after the
// K5 tables (jacobian_big.parts_tables)
template <typename S>
struct DenseTables {
  PartsTables<S> p;
  FinishTables<S> f;
  const S* col_coef;
  const int *col_ptr, *col_src;
};
#define N_TABLES (N_PARTS_TABLES + N_FINISH_TABLES + 3)
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

  S* st = scratch;
  S* roles = st + (size_t)(5 + 3 * N) * B;
  // post rows (jacobian_sparse.post_rows)
  S* post = roles + (size_t)(k + 6) * R * B;
  S* hrow = post + (size_t)(4 * N + 2 * J + 3) * B;
  S* dcpr = hrow + (size_t)N * B;
  S* omega = hrow + (size_t)2 * N * B;
  S* domega = hrow + (size_t)3 * N * B;

  // --- 1. state and NASA-7 thermo (jacobian_big.state_thermo) -------------
  StateScalars<S> s = {};
  if (live)
    s = state_phase(t.p, t.f, N, conp, y, Pin, B, b, w, WARPS, st,
                    post + (size_t)3 * N * B, hrow, dcpr);
  __syncthreads();

  // --- 2. reaction parts into the role rows ---------------------------------
  if (live)
    for (int r = w; r < R; r += WARPS)
      store_roles(reaction_parts<S, HAS_PM>(t.p, d, st, B, b, r, roles),
                  roles, (size_t)k * R + r, R, B, b);
  __syncthreads();

  // --- 3. stoichiometric contractions nu_net^T [q, dq_dT, c_u, cv] -----------
  if (live)
    contract_phase<S, HAS_PM>(t.f, has_spec, N, R, roles + (size_t)k * R * B,
                              B, b, w, WARPS, omega, domega, post,
                              post + (size_t)N * B);
  __syncthreads();

  // --- 4. closure: dy/dt, the temperature column, the post rows ---------------
  if (live && w == 0)
    closure(t.f, N, y, s, hrow, dcpr, omega, domega, B, b, post, Jt, fout);
  __syncthreads();

  // --- 5. the columns 1..J ------------------------------------------------------
  if (live)
    for (int j = w; j < J; j += WARPS)
      finish_column(t.col_ptr + (size_t)j * N, t.col_src, t.col_coef,
                    t.p.inv_mw, roles, post, Jt + (size_t)(j + 1) * N * B, j,
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
