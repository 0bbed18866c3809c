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
// state), the rates' few hundred exp / log calls and the closure.  Tensor
// cores do not apply: the column operand is ~0.05% dense (4553 nonzeros
// of N J x (Sf + Sp + 6) R per state).
//
// What the first design lost: its per-state intermediates.  A block of 32
// states (lane = state) wrote each phase's rows -- thermo, the (Sf + Sp +
// 6) R role rows, the post rows: 32 KB a flagship state in f64 -- to a
// batch-minor global scratch and read them back after __syncthreads.  At
// 1 MB a block and ~530 MB live across the card, L2 held little of it:
// the scratch (1.03 GB at K4's shape, more than J) went to HBM and back,
// and the two phases that move it, the reaction parts and the columns,
// took 88% of K4 (PERF.md: the phase split of
// probes/dense_fused_phases.py).  Moving the rows on chip alone did not
// speed those two phases up: they wait on chains of loads, which a large
// tile makes worse by leaving L1 28 KB of the SM's 256 KB.
//
// What the design does about it: a block of 512 threads owns a tile
// of TS consecutive states and keeps all their rows on the SM, in dynamic
// shared memory (the `shared` placement).  The tile (tile_layout below)
// holds no row it can do without -- omega, domega and the closure's sums
// take the state rows' place once phase 2 has read them, and there is no
// xi_q row without species-specific pdep -- so 8 flagship states fit in
// f64 (16 in f32); the host's planner (ops/kernels.py `tile_plan`) sets
// TS by that footprint, rounded down to whole 32 B sectors of J.  Phases
// 0-4 are csrc/state_tile.cuh's, which K1 runs too: the tile is
// batch-minor with stride TS, so the shared phases of csrc/kinetics.cuh
// run on it unchanged, called with (B, b) = (TS, s): no body is copied.
// Each thread keeps one state s and W - 1 others share it: (0) the
// tile's y and P rows are loaded once; (1) state and thermo
// over species; (2) reaction_parts over reactions taken grouped by
// category (rxn_order), so the TS threads of a warp that share a reaction
// load its tables once and the warp's few reactions take one path, with
// the 2 + 2 slot counts of every shipped mechanism fixed at compile time,
// so the slot arrays stay in registers and not in L1 (local memory);
// (3) the contractions over species, a spare thread group taking the
// closure's sums meanwhile; (4) the closure split in three -- the sums
// over species per state, then at once the temperature row's sums per
// state and each species' rows -- so no warp runs it alone; (5) the
// columns in blocks of G over (column, species row), each column's rows
// longest CSR row first (col_order, which also holds each row's CSR
// range, so one record starts its walk) so a warp's rows walk alike:
// each species row goes straight to J, its temperature-row term to a
// staging region over the q / dq_dT / c_u / c_1 rows (phase 3 was their
// last reader), then the temperature rows, each summed over the rows in
// order.  J, col0 and f are stored TS states at a time, whole sectors
// when TS is a multiple of the sector's states (segments that straddle
// sectors cost 3x: PERF.md).
// A mechanism whose rows exceed shared memory (the 654-species class in
// f64, 258 KB a state) takes the `global` placement: the same kernel on
// a per-block slice of global memory, with persistent blocks (one per
// SM) looping over the tiles so the live slices (~34 MB) stay in L2.
// Dead states of the ragged last tile are skipped.  Nothing is
// read-modify-written and nothing needs atomics; every sum keeps a fixed
// order per state, so a state's result does not depend on its tile (and
// is the pre-tile kernel's, bit for bit).  Against the plain versions the
// sums run in another order (the CSR walks instead of dense matmuls; the
// operand's roles are contracted one by one instead of being added per
// reaction first), so kernel and plain version agree to roundoff, not
// bit for bit.

#include "state_tile.cuh"

#include <cstring>

// the tables (DenseTables) and the counts N_TABLES, N_DIMS, N_PLAN, shared
// with the dy/dt kernel (csrc/dydt.cu)
#include "dense_tables.cuh"

// K4's tile (state_tile_layout's rows, the role array with its Sf + Sp
// slot roles) and, for phase 5, the temperature-row terms of G columns (G
// N rows) staged over the role array's q, dq_dT, c_u and c_1 rows, or,
// where 4R < N, in N rows of their own at the end.  ops/kernels.py
// `dense_tile_rows` counts the same.
__host__ __device__ inline TileLayout tile_layout(int N, int R, int Sf,
                                                  int Sp, int has_spec) {
  const int J = N - 1, k = Sf + Sp;
  TileLayout L = state_tile_layout(N, R, k, has_spec);
  L.G = 4 * R / N < J ? 4 * R / N : J;
  L.stage = L.roles + k * R;
  if (L.G < 1) {
    L.G = 1;
    L.stage = L.rows;
    L.rows += N;
  }
  return L;
}

// One tile of K4 / K3 on a block of TILE_THREADS threads: the states [b0,
// b0 + TS) (those below B live) in the rows at `tile`, phases 0-4 of
// state_tile, then (5) the columns; stops after phase LAST
// (probes/dense_fused_phases.py cuts it there; the launcher's kernel runs
// all five).  SL = 2: every reaction has 2 reactant and 2 product slots
// (else 0: the counts of d; WIDE_SLOTS: the wide path, csrc/kinetics.cuh).
template <typename S, bool HAS_PM, int SL, int LAST>
__device__ __forceinline__ void dense_fused_tile(
    const DenseTables<S>& t, const PartsDims<S>& d, int has_spec, int TS,
    const TileLayout& L, long long b0, const S* __restrict__ y,
    const S* __restrict__ Pin, long long B, S* __restrict__ Jt,
    S* __restrict__ fout, S* __restrict__ tile) {
  state_tile<S, HAS_PM, SL, false, LAST>(t.p, t.f, t.rxn_order, d, has_spec,
                                         TS, L, b0, y, Pin, B, Jt, fout, tile,
                                         SourceOut<S>{});
  if (LAST < 5) return;
  const int N = d.N, J = N - 1, conp = d.conp;
  const int tid = threadIdx.x;
  const int live = (int)(B - b0 < TS ? B - b0 : TS);
  const int W = TILE_THREADS / TS, s = tid % TS, g = tid / TS;
  const bool on = g < W && s < live;
  const long long ts = TS, bs = b0 + s;
  const S* roles = tile + (size_t)L.roles * TS;
  const S* post = tile + (size_t)L.post * TS;

  // --- 5. the columns 1..J, G at a time ---------------------------------------
  S* stage = tile + (size_t)L.stage * TS;
  for (int j0 = 0; j0 < J; j0 += L.G) {
    const int gc = J - j0 < L.G ? J - j0 : L.G;
    if (on) {
      // entries (column j0 + jj, its i-th row in col_order) for i = g,
      // g + W, ... of the block
      int jj = g / N, i = g % N;
      for (int e = g; e < gc * N; e += W) {
        const int j = j0 + jj;
        const int* q = t.col_order + 3 * ((size_t)j * N + i);
        const int n = q[0];
        stage[(size_t)(jj * N + n) * TS + s] = column_entry(
            q[1], q[2], t.col_src, t.col_coef,
            column_scales(t.p.inv_mw, post, j, N, conp, ts, (long long)s),
            roles, post, Jt + (size_t)(j + 1) * N * B, n, N, ts,
            (long long)s, B, bs);
        for (i += W; i >= N; i -= N) ++jj;
      }
    }
    __syncthreads();
    if (on)
      for (int jj = g; jj < gc; jj += W) {
        const int j = j0 + jj;
        S tsum = S(0);
        for (int n = 0; n < N; ++n)
          tsum += stage[(size_t)(jj * N + n) * TS + s];
        column_temperature(
            tsum,
            column_scales(t.p.inv_mw, post, j, N, conp, ts, (long long)s),
            post, Jt + (size_t)(j + 1) * N * B, j, N, ts, (long long)s, bs);
      }
    __syncthreads();
  }
}

// The blocks loop over the tiles; SMEM: a tile's rows in dynamic shared
// memory, else in the block's slice of `scratch` (tile rows x TS values)
template <typename S, bool HAS_PM, int SL, bool SMEM, int LAST>
__global__ void __launch_bounds__(TILE_THREADS, 1)
dense_fused_kernel(DenseTables<S> t, PartsDims<S> d, int has_spec, int TS,
                   long long n_tiles, const S* __restrict__ y,
                   const S* __restrict__ Pin, long long B, S* __restrict__ Jt,
                   S* __restrict__ fout, S* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout L = tile_layout(d.N, d.R, d.Sf, d.Sp, has_spec);
  S* tile = SMEM ? reinterpret_cast<S*>(smem)
                 : scratch + (size_t)blockIdx.x * L.rows * TS;
  for (long long i = blockIdx.x; i < n_tiles; i += gridDim.x)
    dense_fused_tile<S, HAS_PM, SL, LAST>(t, d, has_spec, TS, L, i * TS, y,
                                          Pin, B, Jt, fout, tile);
}

extern "C" int pyjac_dense_fused_n_tables(void) { return N_TABLES; }

// rows of a state's tile (dims as pyjac_dense_fused's): the planner in
// ops/kernels.py must count the same
extern "C" int pyjac_dense_fused_tile_rows(const int* dims) {
  return tile_layout(dims[0], dims[1], dims[2], dims[3], dims[10]).rows;
}

template <typename S, bool HAS_PM, int SL, bool SMEM, int LAST>
static int launch_kernel(const DenseTables<S>& t, const PartsDims<S>& d,
                         int has_spec, int TS, long long n_tiles,
                         unsigned grid, size_t smem, const S* y, const S* P,
                         long long B, S* Jt, S* f, S* scratch,
                         cudaStream_t stream) {
  auto k = dense_fused_kernel<S, HAS_PM, SL, SMEM, LAST>;
  if (smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<grid, TILE_THREADS, smem, stream>>>(t, d, has_spec, TS, n_tiles, y, P, B,
                                     Jt, f, scratch);
  return (int)cudaGetLastError();
}

#define DENSE_FUSED_PARAMS(S)                                              \
  const void *const *tables, int n_tables, const int *dims, int n_dims,    \
      double ln_pa_ru, const S *y, const S *P, long long B, S *Jt, S *f,   \
      S *scratch, const long long *plan, int n_plan, void *stream
#define DENSE_FUSED_ARGS                                                    \
  tables, n_tables, dims, n_dims, ln_pa_ru, y, P, B, Jt, f, scratch, plan, \
      n_plan, stream

template <typename S, int LAST>
static int launch(DENSE_FUSED_PARAMS(S)) {
  if (n_tables != N_TABLES || n_dims != N_DIMS || n_plan != N_PLAN) return -1;
  if (dims[0] < 2 || B < 1) return -1;
  const TileLayout L =
      tile_layout(dims[0], dims[1], dims[2], dims[3], dims[10]);
  const long long TS = plan[0], shared = plan[1], grid = plan[2];
  if (plan[3] != L.rows || TS < 1 || TS > TILE_THREADS || grid < 1) return -1;
  const long long n_tiles = (B + TS - 1) / TS;
  const size_t smem = shared ? (size_t)L.rows * TS * sizeof(S) : 0;
  if (smem > SMEM_MAX || grid > n_tiles) return -1;
  if (grid > 2147483647LL) return -1;
  DenseTables<S> t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<S> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = (S)ln_pa_ru;
  cudaStream_t s = (cudaStream_t)stream;
#define DF_LAUNCH(PM, SL, SM)                                                 \
  launch_kernel<S, PM, SL, SM, LAST>(t, d, dims[10], (int)TS, n_tiles,        \
                                     (unsigned)grid, smem, y, P, B, Jt, f,    \
                                     scratch, s)
  const bool wide = wide_tables(d.Sf, d.Sp, d.NT, d.NP);
#define DF_SLOTS(PM, SM)                                          \
  (wide ? DF_LAUNCH(PM, WIDE_SLOTS, SM)                           \
        : dims[2] == 2 && dims[3] == 2 ? DF_LAUNCH(PM, 2, SM)     \
                                       : DF_LAUNCH(PM, 0, SM))
  if (dims[9])
    return shared ? DF_SLOTS(true, true) : DF_SLOTS(true, false);
  return shared ? DF_SLOTS(false, true) : DF_SLOTS(false, false);
#undef DF_SLOTS
#undef DF_LAUNCH
}

// K4.  tables: N_TABLES device pointers in DenseTables order; dims: N_DIMS
// ints {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac, has_pm, has_spec}; y
// (N, B), P (1, B); writes Jt (N, N, B) and f (N, B).  plan: N_PLAN
// {states per tile TS, shared (1) or global (0) placement, blocks, tile
// rows per state (pyjac_dense_fused_tile_rows)}: `blocks` blocks loop over
// the tiles, each tile's rows in the block's dynamic shared memory
// (shared) or in its slice of scratch (global: blocks x rows x TS values;
// unused under shared).  Returns the launch's cudaError_t (0 on success),
// or -1 on a table / dimension / plan mismatch.
extern "C" int pyjac_dense_fused(const void* const* tables, int n_tables,
                                 const int* dims, int n_dims, double ln_pa_ru,
                                 const double* y, const double* P,
                                 long long B, double* Jt, double* f,
                                 double* scratch, const long long* plan,
                                 int n_plan, void* stream) {
  return launch<double, 5>(DENSE_FUSED_ARGS);
}

// K3: pyjac_dense_fused in float32 (float tables, states, outputs and
// scratch; ln_pa_ru is rounded to float on the host).
extern "C" int pyjac_fused_f32(const void* const* tables, int n_tables,
                               const int* dims, int n_dims, double ln_pa_ru,
                               const float* y, const float* P, long long B,
                               float* Jt, float* f, float* scratch,
                               const long long* plan, int n_plan,
                               void* stream) {
  return launch<float, 5>(DENSE_FUSED_ARGS);
}
