// Phase cuts of the stage-A kernel K1, and K1 and the reaction-parts
// kernel K5 as they were before their redesign, for
// probes/stage_a_phases.py.
//
// * K1: the launcher's own kernel template
//   (pyjac_tpu_torch/csrc/sparse_stage_a.cu, included, not copied)
//   launched through its own `launch<LAST>` with the kernel stopping after
//   phase LAST: 1 the state and thermo, 2 the reaction parts and the
//   source rows, 3 the contractions, 4 the closure, 5 the post rows out
//   (the launcher's kernel); each cut takes the C entry's arguments.
// * parent K1: a block of 32 consecutive states (lane = state) and 4
//   warps, every phase's rows in a batch-minor global scratch of (5 + 3N)
//   + 6R + 4N rows, reaction_parts with run-time slot counts, the closure
//   on warp 0; cut after phase LAST: 1 the state and thermo, 2 the
//   reaction parts and the source rows, 3 the stoichiometric
//   contractions, 4 the closure (the whole kernel).
// * parent K5: one thread per (reaction, state), reaction_parts with
//   run-time slot counts.
//
// Both take the launchers' table and dimension arrays; their outputs are
// the launchers' bit for bit when the arithmetic is the same.

#include "../pyjac_tpu_torch/csrc/sparse_stage_a.cu"

extern "C" int sap_k1(int last, STAGE_A_PARAMS) {
  switch (last) {
    case 1: return launch<1>(STAGE_A_ARGS);
    case 2: return launch<2>(STAGE_A_ARGS);
    case 3: return launch<3>(STAGE_A_ARGS);
    case 4: return launch<4>(STAGE_A_ARGS);
    case 5: return launch<5>(STAGE_A_ARGS);
  }
  return -1;
}

// the first tables of K1's table array: K5's, the closure's, eff_val
struct ParentTables {
  PartsTables<double> p;
  FinishTables<double> f;
  const double* eff_val;
};

template <bool HAS_PM, int LAST>
__global__ void __launch_bounds__(128)
parent_k1(ParentTables t, PartsDims<double> d, int has_spec, int S_eff,
          const double* __restrict__ y, const double* __restrict__ Pin,
          long long B, double* __restrict__ src, double* __restrict__ col0,
          double* __restrict__ fout, double* __restrict__ post,
          double* __restrict__ scratch) {
  const int W = 4;
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

  StateScalars<double> s = {};
  if (live)
    s = state_phase(t.p, t.f, N, d.conp, y, Pin, B, b, w, W, st,
                    post + (size_t)3 * N * B, hrow, dcpr);
  __syncthreads();
  if (LAST < 2) return;

  if (live) {
    for (int r = w; r < R; r += W) {
      const ReactionRoles<double> v =
          reaction_parts<double, HAS_PM>(t.p, d, st, B, b, r, src, B, b);
      store_roles(v, rest, r, R, B, b);
      for (int e = 0; e < S_eff; ++e)
        AT(src, (size_t)(k + e) * R + r) =
            v.psi_q * t.eff_val[(size_t)r * S_eff + e];
      AT(src, (size_t)(k + S_eff) * R + r) = has_spec ? v.xi_q : 0.0;
    }
    if (w == 0) AT(src, (size_t)(k + S_eff + 1) * R) = 0.0;
  }
  __syncthreads();
  if (LAST < 3) return;

  if (live)
    contract_phase<double, HAS_PM>(t.f, has_spec, N, R, rest, B, b, w, W,
                                   omega, domega, post, post + (size_t)N * B);
  __syncthreads();
  if (LAST < 4) return;

  // the closure on warp 0: sums, the temperature row, the species rows
  if (live && w == 0) {
    const ClosureSums<double> c =
        closure_sums(N, y, s, post + (size_t)3 * N * B, dcpr, B, b);
    closure_temperature(t.f, N, s, c, hrow, omega, domega, B, b, post, col0,
                        fout, B, b);
    for (int n = 0; n < N - 1; ++n)
      closure_species(t.f, N, n, s, omega, domega, B, b, post, col0, fout, B,
                      b);
  }
}

extern "C" long long sap_parent_scratch_rows(const int* dims) {
  return (long long)(5 + 3 * dims[0]) + 6LL * dims[1] + 4LL * dims[0];
}

template <int LAST>
static int parent_launch(const ParentTables& t, const PartsDims<double>& d,
                         const int* dims, const double* y, const double* P,
                         long long B, double* src, double* col0, double* f,
                         double* post, double* scratch, cudaStream_t s) {
  const unsigned blocks = (unsigned)((B + 31) / 32);
  dim3 block(32, 4);
  if (dims[9])
    parent_k1<true, LAST><<<blocks, block, 0, s>>>(
        t, d, dims[10], dims[11], y, P, B, src, col0, f, post, scratch);
  else
    parent_k1<false, LAST><<<blocks, block, 0, s>>>(
        t, d, dims[10], dims[11], y, P, B, src, col0, f, post, scratch);
  return (int)cudaGetLastError();
}

// the parent K1 cut after phase `last`: tables (K1's table array, of
// which it reads the first 48), dims {N, R, Sf, Sp, Pm, NT, NP, conp,
// has_frac, has_pm, has_spec, S_eff}, scratch (sap_parent_scratch_rows,
// B)
extern "C" int sap_parent_k1(int last, const void* const* tables,
                             const int* dims, double ln_pa_ru,
                             const double* y, const double* P, long long B,
                             double* src, double* col0, double* f,
                             double* post, double* scratch, void* stream) {
  ParentTables t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<double> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = ln_pa_ru;
  cudaStream_t s = (cudaStream_t)stream;
  switch (last) {
    case 1: return parent_launch<1>(t, d, dims, y, P, B, src, col0, f, post,
                                    scratch, s);
    case 2: return parent_launch<2>(t, d, dims, y, P, B, src, col0, f, post,
                                    scratch, s);
    case 3: return parent_launch<3>(t, d, dims, y, P, B, src, col0, f, post,
                                    scratch, s);
    case 4: return parent_launch<4>(t, d, dims, y, P, B, src, col0, f, post,
                                    scratch, s);
  }
  return -1;
}

template <bool HAS_PM>
__global__ void __launch_bounds__(128)
parent_parts(PartsTables<double> t, PartsDims<double> d,
             const double* __restrict__ st, long long B,
             double* __restrict__ roles) {
  const long long b = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B || blockIdx.x >= (unsigned)d.rows) return;
  const int r = d.row0 + blockIdx.x;
  store_roles(
      reaction_parts<double, HAS_PM>(t, d, st, B, b, r, roles, B, b), roles,
      (size_t)(d.Sf + d.Sp) * d.R + r, d.R, B, b);
}

// the parent K5 with pyjac_big_parts's arguments
extern "C" int sap_parent_parts(const void* const* tables, int n_tables,
                                const int* dims, int n_dims, double ln_pa_ru,
                                const double* st, long long B, int row0,
                                int rows, int has_pm, double* roles,
                                void* stream) {
  PartsTables<double> t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<double> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = row0; d.rows = rows;
  d.ln_pa_ru = ln_pa_ru;
  dim3 grid((unsigned)rows, (unsigned)((B + 127) / 128));
  if (has_pm)
    parent_parts<true><<<grid, 128, 0, (cudaStream_t)stream>>>(t, d, st, B,
                                                               roles);
  else
    parent_parts<false><<<grid, 128, 0, (cudaStream_t)stream>>>(t, d, st, B,
                                                                roles);
  return (int)cudaGetLastError();
}
