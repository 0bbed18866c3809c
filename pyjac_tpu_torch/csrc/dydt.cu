// dy/dt alone in float64, sm_90a: the integrator's right-hand side.
//
// It replaces no TPU kernel: the JAX integrator (pyjac_tpu/integrate.py)
// evaluates f with XLA's fusion of the plain dy/dt.  The port's
// integrator (pyjac_tpu_torch/integrate.py) evaluates f two or three
// times a step; as ~100 small torch ops (ops/dydt.py, its plain version)
// a dy/dt took ~6.7 ms at the flagship's 32768 states, most of the loop's
// card time.  In one launch, from the states y (N, B) and the (1, B)
// pressure (CONP) or density (CONV) row, it writes f (N, B) -- y and f of
// any strides, so the integrator's (B, N) states are read and its f
// written where they lie, with no transpose.  It takes every mechanism
// K4 takes (csrc/dense_fused.cu: every reaction category, the wide path,
// fractional stoichiometry, species-specific pdep, CONP and CONV) and
// K4's tables, and its f is K4's f bit for bit.
//
// What bounds it on this card: operations.  A state reads N + 1 values
// and writes N (0.86 KB at the flagship: 28 MB at B = 32768, 8 us at
// 3.35 TB/s) against the rates' few hundred exp / log calls, the Kc
// sums, the contraction and the closure, ~25,000 operations a flagship
// state (profiling.dydt_ops: 24 us at 34 TFLOP/s).  Below either, what
// sets its time is the chains of dependent loads and the transcendental
// calls' latency, as in K4's phases 0-4.
//
// What the design does about it: it runs K4's own phases 0-4
// (csrc/state_tile.cuh, not a copy) with F_ONLY, a compile-time switch
// that cuts them down to f: phases 0-1 (the tile's y and P rows, the
// state scalars and the NASA-7 thermo) as they are; phase 2 only each
// reaction's net rate q with its pressure modification (reaction_parts'
// own lines, Q_ONLY: no slot roles, no derivative roles); phase 3 only
// omega; phase 4 only dY/dt and dT/dt.  With no derivative roles, no
// post rows and no columns, a state's tile shrinks to 7N + 10 + R rows
// (dydt_tile_layout: 706 at the flagship against K4's 3,572), so a block
// keeps 16 flagship states on the SM against K4's 8 (ops/kernels.py
// DYDT_TILE: of the 41 that would fit, 16 leave L1 the most room and
// each thread group a half warp; they ran 19% faster than 40) and the
// per-tile serial chains (the closure's sums, the dT/dt sum) are shared
// by more states.  dT/dt's divisions, one chain of N in K4's closure, run over
// the tile's threads, one species each, and only their sum stays in
// order on one thread group.  Every sum keeps K4's order and the kernel
// is built with K4's -fmad=false, so f is K4's bit for bit: the
// integrator takes the same steps whichever of the two gives f.  K1, K3
// and K4 instantiate the phases with F_ONLY = false, which compiles to
// the code they had.

#include "state_tile.cuh"

#include <cstring>

#include "dense_tables.cuh"

// the PartsDims of the N_DIMS ints {N, R, Sf, Sp, Pm, NT, NP, conp,
// has_frac, has_pm, has_spec} of the C entry, as K4 / K3 take them
template <typename S>
inline PartsDims<S> dense_dims(const int* dims, double ln_pa_ru) {
  PartsDims<S> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = (S)ln_pa_ru;
  return d;
}

// The blocks loop over the tiles; SMEM: a tile's rows in dynamic shared
// memory, else in the block's slice of `scratch` (tile rows x TS values)
template <typename S, bool HAS_PM, int SL, bool SMEM>
__global__ void __launch_bounds__(TILE_THREADS, 1)
dydt_kernel(DenseTables<S> t, PartsDims<S> d, int has_spec, int TS,
            long long n_tiles, const S* __restrict__ y,
            const S* __restrict__ Pin, long long B, S* __restrict__ fout,
            StateStrides io, S* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout L = dydt_tile_layout(d.N, d.R);
  S* tile = SMEM ? reinterpret_cast<S*>(smem)
                 : scratch + (size_t)blockIdx.x * L.rows * TS;
  for (long long i = blockIdx.x; i < n_tiles; i += gridDim.x)
    state_tile<S, HAS_PM, SL, false, 4, true>(
        t.p, t.f, t.rxn_order, d, has_spec, TS, L, i * TS, y, Pin, B,
        nullptr, fout, tile, SourceOut<S>{}, io);
}

// rows of a state's tile (dims as pyjac_dydt's): the planner in
// ops/kernels.py must count the same
extern "C" int pyjac_dydt_tile_rows(const int* dims) {
  return dydt_tile_layout(dims[0], dims[1]).rows;
}

template <typename S, bool HAS_PM, int SL, bool SMEM>
static int launch_kernel(const DenseTables<S>& t, const PartsDims<S>& d,
                         int has_spec, int TS, long long n_tiles,
                         unsigned grid, size_t smem, const S* y, const S* P,
                         long long B, S* f, const StateStrides& io,
                         S* scratch, cudaStream_t stream) {
  auto k = dydt_kernel<S, HAS_PM, SL, SMEM>;
  if (smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<grid, TILE_THREADS, smem, stream>>>(t, d, has_spec, TS, n_tiles, y, P,
                                          B, f, io, scratch);
  return (int)cudaGetLastError();
}

// The dy/dt kernel.  tables: N_TABLES device pointers in DenseTables order
// (K4's); dims: N_DIMS ints {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac,
// has_pm, has_spec}; y (N, B) at strides (y_r, y_b), P (1, B)
// contiguous; writes f (N, B) at strides (f_r, f_b).  plan: N_PLAN {states
// per tile TS, shared (1) or global (0) placement, blocks, tile rows per
// state (pyjac_dydt_tile_rows)}, as pyjac_dense_fused's.  Returns the
// launch's cudaError_t (0 on success), or -1 on a table / dimension /
// plan mismatch.
extern "C" int pyjac_dydt(const void* const* tables, int n_tables,
                          const int* dims, int n_dims, double ln_pa_ru,
                          const double* y, long long y_r, long long y_b,
                          const double* P, long long B, double* f,
                          long long f_r, long long f_b, double* scratch,
                          const long long* plan, int n_plan, void* stream) {
  if (n_tables != N_TABLES || n_dims != N_DIMS || n_plan != N_PLAN) return -1;
  if (dims[0] < 2 || B < 1) return -1;
  const TileLayout L = dydt_tile_layout(dims[0], dims[1]);
  const long long TS = plan[0], shared = plan[1], grid = plan[2];
  if (plan[3] != L.rows || TS < 1 || TS > TILE_THREADS || grid < 1) return -1;
  const long long n_tiles = (B + TS - 1) / TS;
  const size_t smem = shared ? (size_t)L.rows * TS * sizeof(double) : 0;
  if (smem > SMEM_MAX || grid > n_tiles) return -1;
  if (grid > 2147483647LL) return -1;
  DenseTables<double> t;
  std::memcpy(&t, tables, sizeof(t));
  const PartsDims<double> d = dense_dims<double>(dims, ln_pa_ru);
  const StateStrides io = {y_r, y_b, f_r, f_b};
  cudaStream_t s = (cudaStream_t)stream;
#define DY_LAUNCH(PM, SL, SM)                                              \
  launch_kernel<double, PM, SL, SM>(t, d, dims[10], (int)TS, n_tiles,     \
                                    (unsigned)grid, smem, y, P, B, f, io, \
                                    scratch, s)
  const bool wide = wide_tables(d.Sf, d.Sp, d.NT, d.NP);
#define DY_SLOTS(PM, SM)                                          \
  (wide ? DY_LAUNCH(PM, WIDE_SLOTS, SM)                           \
        : dims[2] == 2 && dims[3] == 2 ? DY_LAUNCH(PM, 2, SM)     \
                                       : DY_LAUNCH(PM, 0, SM))
  if (dims[9])
    return shared ? DY_SLOTS(true, true) : DY_SLOTS(true, false);
  return shared ? DY_SLOTS(false, true) : DY_SLOTS(false, false);
#undef DY_SLOTS
#undef DY_LAUNCH
}
