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
// a few thousand f64 operations and ~2000 exp/log calls.
//
// What the first design lost: a block of 32 states (lane = state) sent
// every phase's per-state intermediates -- the thermo rows and the six
// per-reaction rows q, dq_dT, c_u, c_1, psi_q, xi_q: ~18 KB a flagship
// state, 2.44 GB at B = 131072 -- through a batch-minor global scratch
// to HBM and back, ran reaction_parts with run-time slot counts (its slot
// arrays in local memory) and the closure on one warp of four.
//
// What the design does about it: K4's tile (csrc/state_tile.cuh, whose
// phases both run): a block of 512 threads owns a tile of TS consecutive
// states and keeps their rows on the SM, in dynamic shared memory (the
// `shared` placement, no global scratch).  The tile holds no slot role:
// phase 2 writes those, psi_q times each efficiency slot and xi_q straight
// to the source stack, TS consecutive states a row; it keeps q, dq_dT,
// c_u, c_1, psi_q (xi_q only with species-specific pdep) for the
// contractions.  The reactions run grouped by category (rxn_order), with
// the 2 + 2 slot counts of every shipped mechanism fixed at compile time;
// the contractions and the closure spread over the block, the closure's
// temperature-row terms too (the first design summed them, three
// divisions a species, on one thread a state).  Then (5) the
// post rows go out TS states a row, as col0 and f did from the closure;
// with TS a multiple of 4, every segment is whole 32 B sectors.  The
// host's planner (ops/kernels.py `tile_plan`) sets TS by the tile's
// footprint and a spare thread group (8 flagship or 53/326-synth states,
// 4 of USC-II, one of the 654-species class); a mechanism whose one
// state exceeds shared memory takes the `global` placement: per-block
// slices of a global scratch, persistent blocks looping over the tiles
// so the slices stay in L2.  Each state's sums keep their order, so the
// outputs are those of the first design bit for bit.  Nothing is
// read-modify-written and nothing needs atomics.

#include "state_tile.cuh"

#include <cstring>

// matches the numpy table order of SparseJacobian's kernel tables: the K5
// tables (jacobian_big.parts_tables), the closure's
// (jacobian_sparse.finish_tables), eff_val, then the reaction order
// (jacobian_dense.reaction_order)
struct StageATables {
  PartsTables<double> p;
  FinishTables<double> f;
  const double* eff_val;
  const int* rxn_order;
};
#define N_TABLES (N_PARTS_TABLES + N_FINISH_TABLES + 2)
static_assert(sizeof(StageATables) == N_TABLES * sizeof(void*),
              "StageATables must be N_TABLES pointers");
#define N_DIMS 12
#define N_PLAN 4

// K1's tile: state_tile_layout without slot roles, and phase 4's 3N rows
// of temperature-row terms over the role rows (phase 3 was their last
// reader), or, where those are fewer, in rows of their own at the end.
// ops/kernels.py `stage_a_tile_rows` counts the same.
__host__ __device__ inline TileLayout stage_a_layout(int N, int R,
                                                     int has_spec) {
  TileLayout L = state_tile_layout(N, R, 0, has_spec);
  L.stage = L.roles;
  if (3 * N > (5 + (has_spec ? 1 : 0)) * R) {
    L.stage = L.rows;
    L.rows += 3 * N;
  }
  return L;
}

// One tile of K1: phases 0-4 of state_tile, then (5) the post rows out;
// stops after phase LAST (probes/stage_a_phases.py cuts it there; the
// launcher's kernel runs all five).
template <bool HAS_PM, int SL, int LAST>
__device__ __forceinline__ void stage_a_tile(
    const StageATables& t, const PartsDims<double>& d, int has_spec,
    int S_eff, int TS, const TileLayout& L, long long b0,
    const double* __restrict__ y, const double* __restrict__ Pin, long long B,
    double* __restrict__ src, double* __restrict__ col0,
    double* __restrict__ fout, double* __restrict__ post,
    double* __restrict__ tile) {
  state_tile<double, HAS_PM, SL, true, LAST>(
      t.p, t.f, t.rxn_order, d, has_spec, TS, L, b0, y, Pin, B, col0, fout,
      tile, SourceOut<double>{src, t.eff_val, S_eff});
  if (LAST < 5) return;

  // --- 5. the post rows, TS states a row -------------------------------------
  const int n_post = 4 * d.N + 2 * (d.N - 1) + 3;
  const int live = (int)(B - b0 < TS ? B - b0 : TS);
  const double* tpost = tile + (size_t)L.post * TS;
  for (int i = threadIdx.x; i < n_post * TS; i += TILE_THREADS) {
    const int r = i / TS, si = i % TS;
    if (si < live) post[(size_t)r * B + b0 + si] = tpost[(size_t)r * TS + si];
  }
  __syncthreads();
}

// The blocks loop over the tiles; SMEM: a tile's rows in dynamic shared
// memory, else in the block's slice of `scratch` (tile rows x TS values)
template <bool HAS_PM, int SL, bool SMEM, int LAST>
__global__ void __launch_bounds__(TILE_THREADS, 1)
sparse_stage_a_kernel(StageATables t, PartsDims<double> d, int has_spec,
                      int S_eff, int TS, long long n_tiles,
                      const double* __restrict__ y,
                      const double* __restrict__ Pin, long long B,
                      double* __restrict__ src, double* __restrict__ col0,
                      double* __restrict__ fout, double* __restrict__ post,
                      double* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout L = stage_a_layout(d.N, d.R, has_spec);
  double* tile = SMEM ? reinterpret_cast<double*>(smem)
                      : scratch + (size_t)blockIdx.x * L.rows * TS;
  for (long long i = blockIdx.x; i < n_tiles; i += gridDim.x)
    stage_a_tile<HAS_PM, SL, LAST>(t, d, has_spec, S_eff, TS, L, i * TS, y,
                                   Pin, B, src, col0, fout, post, tile);
}

extern "C" int pyjac_stage_a_n_tables(void) { return N_TABLES; }

// rows of a state's tile (dims as pyjac_stage_a's): the planner in
// ops/kernels.py must count the same
extern "C" int pyjac_stage_a_tile_rows(const int* dims) {
  return stage_a_layout(dims[0], dims[1], dims[10]).rows;
}

template <bool HAS_PM, int SL, bool SMEM, int LAST>
static int launch_kernel(const StageATables& t, const PartsDims<double>& d,
                         int has_spec, int S_eff, int TS, long long n_tiles,
                         unsigned grid, size_t smem, const double* y,
                         const double* P, long long B, double* src,
                         double* col0, double* f, double* post,
                         double* scratch, cudaStream_t stream) {
  auto k = sparse_stage_a_kernel<HAS_PM, SL, SMEM, LAST>;
  if (smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<grid, TILE_THREADS, smem, stream>>>(t, d, has_spec, S_eff, TS, n_tiles,
                                          y, P, B, src, col0, f, post,
                                          scratch);
  return (int)cudaGetLastError();
}

#define STAGE_A_PARAMS                                                       \
  const void *const *tables, int n_tables, const int *dims, int n_dims,      \
      double ln_pa_ru, const double *y, const double *P, long long B,        \
      double *src, double *col0, double *f, double *post, double *scratch,   \
      const long long *plan, int n_plan, void *stream
#define STAGE_A_ARGS                                                          \
  tables, n_tables, dims, n_dims, ln_pa_ru, y, P, B, src, col0, f, post,     \
      scratch, plan, n_plan, stream

template <int LAST>
static int launch(STAGE_A_PARAMS) {
  if (n_tables != N_TABLES || n_dims != N_DIMS || n_plan != N_PLAN) return -1;
  if (dims[0] < 2 || dims[11] < 0 || B < 1) return -1;
  const TileLayout L = stage_a_layout(dims[0], dims[1], dims[10]);
  const long long TS = plan[0], shared = plan[1], grid = plan[2];
  if (plan[3] != L.rows || TS < 1 || TS > TILE_THREADS || grid < 1) return -1;
  const long long n_tiles = (B + TS - 1) / TS;
  const size_t smem = shared ? (size_t)L.rows * TS * sizeof(double) : 0;
  if (smem > SMEM_MAX || grid > n_tiles || grid > 2147483647LL) return -1;
  StageATables t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<double> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = ln_pa_ru;
  cudaStream_t s = (cudaStream_t)stream;
#define SA_LAUNCH(PM, SL, SM)                                                 \
  launch_kernel<PM, SL, SM, LAST>(t, d, dims[10], dims[11], (int)TS, n_tiles, \
                                  (unsigned)grid, smem, y, P, B, src, col0,   \
                                  f, post, scratch, s)
  const bool wide = wide_tables(d.Sf, d.Sp, d.NT, d.NP);
#define SA_SLOTS(PM, SM)                                          \
  (wide ? SA_LAUNCH(PM, WIDE_SLOTS, SM)                           \
        : dims[2] == 2 && dims[3] == 2 ? SA_LAUNCH(PM, 2, SM)     \
                                       : SA_LAUNCH(PM, 0, SM))
  if (dims[9])
    return shared ? SA_SLOTS(true, true) : SA_SLOTS(true, false);
  return shared ? SA_SLOTS(false, true) : SA_SLOTS(false, false);
#undef SA_SLOTS
#undef SA_LAUNCH
}

// tables: N_TABLES device pointers in StageATables order; dims: N_DIMS
// ints {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, has_pm, has_spec,
// S_eff}; y (N, B), P (1, B); writes src (n_src, B), col0 and f (N, B) and
// post (4N + 2J + 3, B).  plan: N_PLAN {states per tile TS, shared (1) or
// global (0) placement, blocks, tile rows per state
// (pyjac_stage_a_tile_rows)}: `blocks` blocks loop over the tiles, each
// tile's rows in the block's dynamic shared memory (shared) or in its
// slice of scratch (global: blocks x rows x TS values; unused under
// shared).  Returns the launch's cudaError_t (0 on success), or -1 on a
// table / dimension / plan mismatch.
extern "C" int pyjac_stage_a(STAGE_A_PARAMS) {
  return launch<5>(STAGE_A_ARGS);
}
