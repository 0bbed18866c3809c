// Stage A of the compressed sparse Jacobian pipeline (K1), float64, sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py `_kernel_dd_src`
// (launched from `PallasDDJacobianSparse.stage_a`): per state, NASA
// thermo, rates and pressure modification, the per-slot assembly values,
// dy/dt and the temperature column (`_compute_dd`, then `_finish_dd`).  It
// writes the stacked per-reaction source array
//   [vals_f_s; vals_p_s; psi_q*effval_s; xi_q|0; zero row]   (n_src, B)
// plus col0 (N, B), f (N, B) and the nine column-finishing rows of
// `_postcol_stream_spec` packed into one post (4N + 2J + 3, B) array.
// Every reaction category the TPU kernel takes: Arrhenius (negative A
// included), PLOG, Chebyshev, reversible via Kc, third-body, Lindemann /
// Troe / SRI falloff, chemically activated, species-specific pdep,
// fractional stoichiometry; CONP and CONV.  Its plain PyTorch version is
// `stage_a_reference` in pyjac_tpu_torch/ops/jacobian_sparse.py.
//
// What bounds it on this card: bytes.  A 53-species / 325-reaction
// flagship state writes 1951 source rows and 425 other rows (col0, f,
// post), 19 KB in f64 (0.761 ms at B = 131072 and 3.35 TB/s), against
// a few thousand f64 operations and ~2000 exp/log calls.  The per-state
// intermediates (the thermo rows and the six per-reaction rows q, dq_dT,
// c_u, c_1, psi_q, xi_q: ~18 KB a flagship state) go through a
// batch-minor global scratch, as in K4.
//
// What the design does about it: K4's shape without its columns.  A block
// owns 32 consecutive states (lane = state, so every load and store of a
// warp covers 32 consecutive doubles and every table read is one address
// for the warp) and runs WARPS warps over them, meeting at
// __syncthreads: (1) the state and the thermo of species n = w, w + WARPS,
// ...; (2) the reaction parts of reactions r = w, ... (`reaction_parts`,
// the K5 body of csrc/kinetics.cuh, which K4 and K3 run too), whose slot
// roles land straight in the source stack and whose six other rows go to
// the scratch, then the reaction's third-body and species-pdep source
// rows; (3) the contractions of species n = w, ... over nu_net^T (a CSR
// over reactions), the four sums in registers; (4) the closure on warp 0.
// Phases 1, 3 and 4 are K4's (kinetics.cuh's state_phase, contract_phase,
// closure).  Nothing is read-modify-written and nothing needs atomics.

#include "kinetics.cuh"

#include <cstring>

#define WARPS 4

// matches the numpy table order of SparseJacobian's kernel tables: the K5
// tables (jacobian_big.parts_tables), the closure's
// (jacobian_sparse.finish_tables), then eff_val (R, S_eff)
struct StageATables {
  PartsTables<double> p;
  FinishTables<double> f;
  const double* eff_val;
};
#define N_TABLES (N_PARTS_TABLES + N_FINISH_TABLES + 1)
static_assert(sizeof(StageATables) == N_TABLES * sizeof(void*),
              "StageATables must be N_TABLES pointers");
#define N_DIMS 12

// scratch rows: state/thermo rows (5 + 3N), the six per-reaction rows
// (6 R), then h, dcp, omega, domega (N each)
static long long scratch_rows(int N, int R) {
  return (long long)(5 + 3 * N) + 6LL * R + 4 * N;
}

// K1's body for a block of 32 states x W warps (threadIdx.y = warp); the
// launcher's kernel below runs it at W = WARPS, and
// probes/stage_a_kernels.py wraps it at other warp counts and launch
// bounds
template <bool HAS_PM, int W>
__device__ __forceinline__ void
stage_a_block(StageATables t, PartsDims<double> d, int has_spec,
              int S_eff, const double* __restrict__ y,
              const double* __restrict__ Pin, long long B,
              double* __restrict__ src, double* __restrict__ col0,
              double* __restrict__ fout, double* __restrict__ post,
              double* __restrict__ scratch) {
  const long long b = (long long)blockIdx.x * 32 + threadIdx.x;
  const int w = threadIdx.y;
  const bool live = b < B;
  const int N = d.N, R = d.R, k = d.Sf + d.Sp;

  double* st = scratch;
  double* rest = st + (size_t)(5 + 3 * N) * B;
  double* hrow = rest + (size_t)6 * R * B;
  double* dcpr = hrow + (size_t)N * B;
  double* omega = hrow + (size_t)2 * N * B;
  double* domega = hrow + (size_t)3 * N * B;

  // --- 1. state and NASA-7 thermo -------------------------------------------
  StateScalars<double> s = {};
  if (live)
    s = state_phase(t.p, t.f, N, d.conp, y, Pin, B, b, w, W, st,
                    post + (size_t)3 * N * B, hrow, dcpr);
  __syncthreads();

  // --- 2. reaction parts: the slot rows into src, the rest into scratch -----
  if (live) {
    for (int r = w; r < R; r += W) {
      const ReactionRoles<double> v =
          reaction_parts<double, HAS_PM>(t.p, d, st, B, b, r, src);
      store_roles(v, rest, r, R, B, b);
      for (int e = 0; e < S_eff; ++e)
        AT(src, (size_t)(k + e) * R + r) =
            v.psi_q * t.eff_val[(size_t)r * S_eff + e];
      AT(src, (size_t)(k + S_eff) * R + r) = has_spec ? v.xi_q : 0.0;
    }
    if (w == 0) AT(src, (size_t)(k + S_eff + 1) * R) = 0.0;   // the zero row
  }
  __syncthreads();

  // --- 3. stoichiometric contractions nu_net^T [q, dq_dT, c_u, cv] ----------
  if (live)
    contract_phase<double, HAS_PM>(t.f, has_spec, N, R, rest, B, b, w, W,
                                   omega, domega, post, post + (size_t)N * B);
  __syncthreads();

  // --- 4. closure: dy/dt, the temperature column, the post rows -------------
  if (live && w == 0)
    closure(t.f, N, y, s, hrow, dcpr, omega, domega, B, b, post, col0, fout);
}

template <bool HAS_PM>
__global__ void __launch_bounds__(32 * WARPS)
sparse_stage_a_kernel(StageATables t, PartsDims<double> d, int has_spec,
                      int S_eff, const double* __restrict__ y,
                      const double* __restrict__ Pin, long long B,
                      double* __restrict__ src, double* __restrict__ col0,
                      double* __restrict__ fout, double* __restrict__ post,
                      double* __restrict__ scratch) {
  stage_a_block<HAS_PM, WARPS>(t, d, has_spec, S_eff, y, Pin, B, src, col0,
                               fout, post, scratch);
}

extern "C" int pyjac_stage_a_n_tables(void) { return N_TABLES; }

// rows of the (rows, B) scratch pyjac_stage_a needs; dims as there
extern "C" long long pyjac_stage_a_scratch_rows(const int* dims) {
  return scratch_rows(dims[0], dims[1]);
}

// tables: N_TABLES device pointers in StageATables order; dims: N_DIMS
// ints {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, has_pm, has_spec,
// S_eff}; y (N, B), P (1, B); writes src (n_src, B), col0 and f (N, B) and
// post (4N + 2J + 3, B) through scratch (pyjac_stage_a_scratch_rows(dims),
// B).  Returns the launch's cudaError_t (0 on success), or -1 on a table
// or dimension mismatch.
extern "C" int pyjac_stage_a(const void* const* tables, int n_tables,
                             const int* dims, int n_dims, double ln_pa_ru,
                             const double* y, const double* P, long long B,
                             double* src, double* col0, double* f,
                             double* post, double* scratch, void* stream) {
  if (n_tables != N_TABLES || n_dims != N_DIMS) return -1;
  if (dims[0] < 2 || dims[2] > MAX_SLOTS || dims[3] > MAX_SLOTS ||
      dims[5] > MAX_CHEB || dims[6] > MAX_CHEB || dims[11] < 0 || B < 1)
    return -1;
  StageATables t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<double> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = ln_pa_ru;
  const long long blocks = (B + 31) / 32;
  if (blocks > 2147483647LL) return -1;
  dim3 block(32, WARPS);
  if (dims[9])
    sparse_stage_a_kernel<true><<<(unsigned)blocks, block, 0,
                                  (cudaStream_t)stream>>>(
        t, d, dims[10], dims[11], y, P, B, src, col0, f, post, scratch);
  else
    sparse_stage_a_kernel<false><<<(unsigned)blocks, block, 0,
                                   (cudaStream_t)stream>>>(
        t, d, dims[10], dims[11], y, P, B, src, col0, f, post, scratch);
  return (int)cudaGetLastError();
}
