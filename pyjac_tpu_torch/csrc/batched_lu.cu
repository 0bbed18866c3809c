// Batched LU factor with partial pivoting, and its solve, for the
// integrator's iteration matrices: float64, sm_90a.
//
// Replaces no TPU kernel.  The JAX package factors W in XLA
// (pyjac_tpu/integrate.py `gauss_solve`, an elimination written because
// XLA:TPU could not compile an f64 LU) and the port first left it to the
// library (torch.linalg.lu_factor_ex / lu_solve).  On the card that
// library ran at ~5% of its bound (PERF.md): row swaps as a kernel of
// their own (MAGMA's dlaswp_rowparallel_kernel_batched), and a workspace
// allocated and freed on every factor.  These two kernels take its place
// for every N whose matrix one block holds on chip (pyjac_tpu_torch/
// integrate.py `lu_factor` / `lu_solve`, by N, through the operators
// pyjac_tpu_torch::lu_factor / ::lu_solve of ops/kernels.py); above that
// the library runs, and on the CPU the same library is the plain version.
//
// What they compute: lu_factor forms W_b = I - s_b J_b as it loads J (the
// stage Jacobian, read through its strides, so both K4's [column, row,
// batch] output and a (B, N, N) array go through unchanged) and factors
// it as LAPACK's getrf does: at step k the first row of largest |a_ik|
// (i >= k, in the rows' current order) is the pivot, rows k and p
// interchange, the column below the pivot scales by its reciprocal, the
// trailing block takes the rank-1 update (fused multiply-adds).  It
// writes what lu_factor_ex writes: LU (B, N, N), the 1-based pivots (B,
// N), and ok (B,), 0 where a pivot is exactly zero (getrf's info != 0).
// A non-finite W spreads into LU, so its solves are not finite.  lu_solve
// applies the interchanges to a right-hand side (B, N) in order, then L
// (unit diagonal) and U.
//
// What bounds them on this card: bytes.  At the integrate cell (53
// species, B = 32768) the factor reads J and writes LU, 2 x 736 MB (0.44
// ms at 3.35 TB/s), and each stage solve reads LU once, 736 MB (0.22
// ms), against 2/3 N^3 + 2 N^2 flops a state (3.3 GFLOP a factor: 0.10 ms
// at 34 TFLOP/s).  On the SM the elimination is a chain of N dependent
// steps a state, each with a pivot search across rows; the card hides
// that chain only with many states in flight, and shared memory holds ~8
// flagship states an SM.
//
// What the design does about it:
// - factor: a block owns a tile of TS consecutive states (two, or one
//   where two do not fit: ops/kernels.py `lu_tile`, its choice), LU_WARPS
//   warps a state.  The tile is loaded TS states at a time, so a batch-minor J
//   is read a sector's TS states a load (a batch-major J along its rows),
//   eight loads in flight a thread, and W is formed on the way into
//   shared memory: no W, no permuted copy of J and no workspace is ever
//   written to global memory.  Nothing is written over J either: its
//   caller keeps it.  In shared memory each state is row-major with an
//   odd row stride, so a warp reading a column touches each bank once.
//   No row moves: the interchanges act on the rows' order (a permutation
//   in shared memory) and the rows go out in that order at the end, so
//   a step is one block barrier and no swap.  Warp 0 updates column k +
//   1 first and picks the next pivot from its registers (a shuffle
//   reduction) while the other warps update the rest of the trailing
//   block.  LU and the pivots go out as each state's contiguous run,
//   whole lines.
// - solve: a warp a state, x in registers (lane c % 32 holds x_c).  A row
//   of L or U is one coalesced load a 32-column slot, the next row's
//   loads in flight while the warp sums this one.  (Fewer lanes a state,
//   or loads further ahead, measured no faster: PERF.md.)
// Each state's arithmetic is the same whatever its tile and however many
// warps share it, so a state's result depends on neither.

#include <cuda_runtime.h>
#include <cfloat>

#define LU_SMEM_MAX 232448   // dynamic shared memory a block may use, bytes
#define LU_MAX_TILE 2        // states a factor block at most
#define LU_WARPS 4           // warps a state in the factor
#define LU_MAX_SLOTS 6       // rows a lane holds in the factor: 32 x 6 >= 168
#define LU_BATCH 8           // loads in flight a thread while a tile loads
#define LU_SOLVE_WARPS 4     // states (a warp each) a solve block

// A state's row stride in shared memory: odd, so the 32 lanes reading a
// column fall in distinct banks.
__host__ __device__ inline int lu_row(int N) { return N | 1; }

// Shared memory of one state in the factor: the matrix, the pivot and its
// reciprocal (two of each, one step's read while the next is written),
// the row permutation (two, likewise) and the N pivots.
// ops/kernels.py `lu_state_bytes` counts the same.
__host__ __device__ inline long long lu_state_bytes(int N) {
  return (long long)N * lu_row(N) * sizeof(double) + 4 * sizeof(double) +
         3LL * N * sizeof(int);
}

// Rows a lane holds in the factor's step: rows k+1 .. N-1 over 32 lanes.
__host__ __device__ inline int lu_slots(int N) {
  return N > 1 ? (N - 1 + 31) / 32 : 1;
}

// A lane's candidate for getrf's pivot (idamax): its first value of
// largest |value|, at position i in the rows' current order.
__device__ inline void lu_candidate(double v, int i, double& best, int& bi,
                                    int N) {
  if (bi == N || fabs(v) > fabs(best)) {
    best = v;
    bi = i;
  }
}

// The warp's pivot from its lanes' candidates (position N where a lane
// has none): the first position of largest |value|.  Lane 0 records it,
// 1-based, in ipv[step], and the pivot and its reciprocal in slot[0..1];
// the rows' order `from` goes to `to` with positions step and the
// pivot's exchanged (getrf's row interchange, on the order alone).
// Returns whether the pivot is nonzero.
__device__ inline bool lu_pivot(double best, int bi, int N, int lane,
                                int step, const int* from, int* to,
                                int* ipv, double* slot) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const double ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (oi < N && (bi == N || fabs(ob) > fabs(best) ||
                   (fabs(ob) == fabs(best) && oi < bi))) {
      best = ob;
      bi = oi;
    }
  }
  // lane 0's choice for all (with a NaN in the column the lanes'
  // comparisons need not agree)
  bi = __shfl_sync(0xffffffffu, bi, 0);
  for (int i = lane; i < N; i += 32)
    to[i] = i == step ? from[bi] : i == bi ? from[step] : from[i];
  if (lane == 0) {
    ipv[step] = bi + 1;
    slot[0] = best;
    slot[1] = __drcp_rn(best);
  }
  return best != 0.0;
}

// One tile of the factor.  The states' W stay where they were loaded: getrf's row interchanges act on
// a permutation, the rows' current order (position -> row of the tile),
// and the rows go out in that order at the end.  LU_WARPS warps a state,
// one block barrier a step k: every warp reads the order and scales the
// multipliers of column k into registers, a lane a row (position k + 1 +
// lane + 32 r); warp 0 updates column k + 1 and, its values in
// registers, picks step k + 1's pivot into the other order buffer; the
// other warps update the rest of the trailing block, four columns at a
// time, loads before stores, the last of them first writing column k -
// 1's multipliers (held since the step before: no warp reads that column
// any more).
template <int RS>
__global__ void __launch_bounds__(LU_MAX_TILE * LU_WARPS * 32)
lu_factor_kernel(const double* __restrict__ J, long long sb, long long sr,
                 long long sc, const double* __restrict__ s, int N,
                 long long B, int TS, double* __restrict__ LU,
                 int* __restrict__ piv, unsigned char* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = lu_row(N), NN = N * N, nthr = blockDim.x;
  double* A = reinterpret_cast<double*>(smem);
  double* S = A + (size_t)TS * N * L;  // per state: [2][pivot, 1 / pivot]
  int* P = reinterpret_cast<int*>(S + 4 * TS);  // per state: [2][N] order,
                                                // N pivots
  const long long b0 = (long long)blockIdx.x * TS;
  const int live = B - b0 < TS ? (int)(B - b0) : TS;
  // Each thread keeps one state of the tile and walks its elements with
  // a fixed stride, its (row, column) carried along without a division.
  // Loads take the states fastest where the batch is J's contiguous
  // dimension, else the elements, the smaller of J's row and column
  // strides fastest.
  const int per = nthr / TS;  // threads a state (TS divides the block)
  const bool minor = sb == 1;
  const bool cfast = sc <= sr;

  // (0) W = I - s_b J_b into the tile
  {
    const int tl = minor ? threadIdx.x % TS : threadIdx.x / per;
    const int e0 = minor ? threadIdx.x / TS : threadIdx.x % per;
    const long long b = b0 + tl;
    const double sv = tl < live ? __ldg(s + b) : 0.0;
    const double* Jb = J + b * sb;
    double* At = A + (size_t)tl * N * L;
    // the fast index f and the slow one g of element e = g N + f
    int f = e0 % N, g = e0 / N;
    const int df = per % N, dg = per / N;
    const long long fs = cfast ? sc : sr, gs = cfast ? sr : sc;
    const int fl = cfast ? 1 : L, gl = cfast ? L : 1;
    for (int e = e0; tl < live && e < NN; e += LU_BATCH * per) {
      double v[LU_BATCH];
      int at[LU_BATCH];
#pragma unroll
      for (int u = 0; u < LU_BATCH; ++u) {
        at[u] = -1;
        v[u] = 0.0;
        if (e + u * per < NN) {
          v[u] = (f == g ? 1.0 : 0.0) - sv * __ldg(Jb + f * fs + g * gs);
          at[u] = f * fl + g * gl;
        }
        f += df;
        g += dg;
        if (f >= N) {
          f -= N;
          ++g;
        }
      }
#pragma unroll
      for (int u = 0; u < LU_BATCH; ++u)
        if (at[u] >= 0) At[at[u]] = v[u];
    }
  }
  __syncthreads();

  const int t = threadIdx.x / (LU_WARPS * 32);
  const int w = (threadIdx.x >> 5) % LU_WARPS, lane = threadIdx.x & 31;
  const bool alive = t < live;
  double* a = A + (size_t)t * N * L;
  double* slot = S + 4 * t;
  int* order = P + t * 3 * N;  // [2][N]
  int* ipv = order + 2 * N;
  // the warp that writes the multipliers a step late, and the warps that
  // share the columns past k + 1 (warp 0 alone where it is the only one)
  const int wl = LU_WARPS - 1, w0 = LU_WARPS > 1 ? 1 : 0;
  bool good = true;  // warp 0: no zero pivot so far
  double l[RS];
  int q[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    l[r] = 0.0;
    q[r] = -1;
  }
  if (alive && w == 0) {
    double best = 0.0;
    int bi = N;
    for (int i = lane; i < N; i += 32) {
      order[N + i] = i;  // the order before step 0
      lu_candidate(a[i * L], i, best, bi, N);
    }
    __syncwarp();
    good = lu_pivot(best, bi, N, lane, 0, order + N, order, ipv, slot);
  }
  __syncthreads();

  for (int k = 0; k + 1 < N; ++k) {
    const int* cur = order + N * (k & 1);
    int* nxt = order + N * ((k + 1) & 1);
    if (alive) {
      if (w == wl && k > 0) {  // column k - 1's multipliers
#pragma unroll
        for (int r = 0; r < RS; ++r)
          if (q[r] >= 0) a[q[r] * L + k - 1] = l[r];
      }
      const double* sl = slot + 2 * (k & 1);
      const double pv = sl[0], rcp = sl[1];
      const bool tiny = !(fabs(pv) >= DBL_MIN);  // (also NaN)
      const double* urow = a + cur[k] * L;  // the pivot row
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        const int i = k + 1 + lane + 32 * r;
        q[r] = i < N ? cur[i] : -1;
        const double v = q[r] >= 0 ? a[q[r] * L + k] : 0.0;
        l[r] = pv == 0.0 ? v : tiny ? v / pv : v * rcp;
      }
      if (w == 0) {  // column k + 1, then step k + 1's pivot
        const double u = urow[k + 1];
        double best = 0.0;
        int bi = N;
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          if (q[r] >= 0) {
            const double x = fma(-l[r], u, a[q[r] * L + k + 1]);
            a[q[r] * L + k + 1] = x;
            lu_candidate(x, k + 1 + lane + 32 * r, best, bi, N);
          }
        }
        good &= lu_pivot(best, bi, N, lane, k + 1, cur, nxt, ipv,
                         slot + 2 * ((k + 1) & 1));
      }
      if (w >= w0) {  // the rest of the trailing block
        const int G = LU_WARPS - w0;
        int j = k + 2 + w - w0;
        for (; j + 3 * G < N; j += 4 * G) {
          double u[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) u[c] = urow[j + c * G];
#pragma unroll
          for (int r = 0; r < RS; ++r) {
            if (q[r] >= 0) {
              double* row = a + q[r] * L + j;
              double x[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) x[c] = row[c * G];
#pragma unroll
              for (int c = 0; c < 4; ++c) row[c * G] = fma(-l[r], u[c], x[c]);
            }
          }
        }
        for (; j < N; j += G) {
          const double u = urow[j];
#pragma unroll
          for (int r = 0; r < RS; ++r)
            if (q[r] >= 0) a[q[r] * L + j] = fma(-l[r], u, a[q[r] * L + j]);
        }
      }
    }
    __syncthreads();
  }
  if (alive && w == wl && N > 1) {  // column N - 2's multipliers
#pragma unroll
    for (int r = 0; r < RS; ++r)
      if (q[r] >= 0) a[q[r] * L + N - 2] = l[r];
  }
  if (alive && w == 0 && lane == 0) ok[b0 + t] = good ? 1 : 0;
  __syncthreads();

  // (2) LU (B, N, N) and the pivots (B, N), the rows in their final order,
  // each state's run of N^2 values written whole
  {
    const int tl = threadIdx.x / per, e0 = threadIdx.x % per;
    const double* At = A + (size_t)tl * N * L;
    const int* fin = P + tl * 3 * N + N * ((N - 1) & 1);
    double* out = LU + (b0 + tl) * NN;
    int c = e0 % N, r = e0 / N;
    const int dc = per % N, dr = per / N;
    for (int e = e0; tl < live && e < NN; e += per) {
      out[e] = At[fin[r] * L + c];
      c += dc;
      r += dr;
      if (c >= N) {
        c -= N;
        ++r;
      }
    }
    for (int k = e0; tl < live && k < N; k += per)
      piv[(b0 + tl) * N + k] = P[tl * 3 * N + 2 * N + k];
  }
}

// The solve: a warp a state, lane c % 32 holding x_c in its register slot
// c / 32.  A row's elements are one coalesced load a slot (the state's LU
// is one run of N^2 values), each lane multiplies its own x, the warp sums
// in five shuffles, and the row's lane takes the result; the next row's
// loads are in flight meanwhile.  The right-hand side and the pivots come
// in through the warp's shared memory, all lanes loading, and lane 0
// applies the interchanges there in order (laswp).
template <int RS>
__global__ void __launch_bounds__(LU_SOLVE_WARPS * 32)
lu_solve_kernel(const double* __restrict__ LU, const int* __restrict__ piv,
                const double* __restrict__ rhs, double* __restrict__ x, int N,
                long long B) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * LU_SOLVE_WARPS + w;
  if (b >= B) return;  // (warp-uniform; no block barrier below)
  double* xs = reinterpret_cast<double*>(smem) + w * N;
  int* ps = reinterpret_cast<int*>(reinterpret_cast<double*>(smem) +
                                   LU_SOLVE_WARPS * N) + w * N;
  for (int c = lane; c < N; c += 32) {
    xs[c] = rhs[b * N + c];
    ps[c] = __ldg(piv + b * N + c);
  }
  __syncwarp();
  if (lane == 0)
    for (int k = 0; k < N; ++k) {
      const int pk = ps[k] - 1;
      if (pk != k) {
        const double v = xs[k];
        xs[k] = xs[pk];
        xs[pk] = v;
      }
    }
  __syncwarp();
  double xv[RS], row[RS];
#pragma unroll
  for (int m = 0; m < RS; ++m) {
    const int c = lane + 32 * m;
    xv[m] = c < N ? xs[c] : 0.0;
  }
  const double* lu = LU + b * N * N;  // element (r, c) at lu[r N + c]
  // row r's slot m, or 0 past the matrix
  auto load = [&](int r, int m) {
    const int c = lane + 32 * m;
    return r >= 0 && r < N && c < N ? __ldg(lu + r * N + c) : 0.0;
  };
  // L y = P rhs: y_r = rhs_r - sum_{c < r} l_rc y_c
#pragma unroll
  for (int m = 0; m < RS; ++m) row[m] = load(1, m);
  for (int r = 1; r < N; ++r) {
    double acc = 0.0;
#pragma unroll
    for (int m = 0; m < RS; ++m) {
      if (lane + 32 * m < r) acc = fma(row[m], xv[m], acc);
      row[m] = load(r + 1, m);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
#pragma unroll
    for (int m = 0; m < RS; ++m)
      if (lane + 32 * m == r) xv[m] -= acc;
  }
  // U x = y: x_r = (y_r - sum_{c > r} u_rc x_c) / u_rr
#pragma unroll
  for (int m = 0; m < RS; ++m) row[m] = load(N - 1, m);
  for (int r = N - 1; r >= 0; --r) {
    double acc = 0.0, diag = 0.0;
#pragma unroll
    for (int m = 0; m < RS; ++m) {
      const int c = lane + 32 * m;
      if (c > r && c < N) acc = fma(row[m], xv[m], acc);
      if (c == r) diag = row[m];
      row[m] = load(r - 1, m);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
#pragma unroll
    for (int m = 0; m < RS; ++m)
      if (lane + 32 * m == r) xv[m] = (xv[m] - acc) / diag;
  }
#pragma unroll
  for (int m = 0; m < RS; ++m) {
    const int c = lane + 32 * m;
    if (c < N) x[b * N + c] = xv[m];
  }
}

// Bytes of shared memory one state takes in the factor (the planner in
// ops/kernels.py must count the same).
extern "C" long long pyjac_lu_state_bytes(int N) { return lu_state_bytes(N); }

template <int RS>
static int launch_factor(const double* J, long long sb, long long sr,
                         long long sc, const double* s, int N, long long B,
                         int TS, double* LU, int* piv, unsigned char* ok,
                         long long grid, long long smem, cudaStream_t stream) {
  auto k = lu_factor_kernel<RS>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)grid, TS * LU_WARPS * 32, (size_t)smem, stream>>>(
      J, sb, sr, sc, s, N, B, TS, LU, piv, ok);
  return (int)cudaGetLastError();
}

// The factor.  J: the (B, N, N) stage Jacobians, element (b, r, c) at
// J[b sb + r sr + c sc]; s (B,); TS states a block (1 to LU_MAX_TILE, the
// planner's).  Writes LU (B, N, N) (row-major: L below the diagonal, U on
// and above it), piv (B, N) int32 (1-based, getrf's) and ok (B,) bytes.
// Returns the launch's cudaError_t (0 on success), or -1 on a dimension
// mismatch.
extern "C" int pyjac_lu_factor(const double* J, long long sb, long long sr,
                               long long sc, const double* s, int N,
                               long long B, int TS, double* LU, int* piv,
                               unsigned char* ok, void* stream) {
  if (N < 1 || B < 1 || TS < 1 || TS > LU_MAX_TILE) return -1;
  const long long smem = TS * lu_state_bytes(N);
  if (smem > LU_SMEM_MAX || lu_slots(N) > LU_MAX_SLOTS) return -1;
  const long long grid = (B + TS - 1) / TS;
  if (grid > 2147483647LL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
#define LU_FACTOR(RS)                                                      \
  launch_factor<RS>(J, sb, sr, sc, s, N, B, TS, LU, piv, ok, grid, smem, st)
  switch (lu_slots(N)) {
    case 1: return LU_FACTOR(1);
    case 2: return LU_FACTOR(2);
    case 3: return LU_FACTOR(3);
    case 4: return LU_FACTOR(4);
    case 5: return LU_FACTOR(5);
    default: return LU_FACTOR(6);
  }
#undef LU_FACTOR
}

template <int RS>
static int launch_solve(const double* LU, const int* piv, const double* rhs,
                        double* x, int N, long long B, cudaStream_t stream) {
  const long long grid = (B + LU_SOLVE_WARPS - 1) / LU_SOLVE_WARPS;
  if (grid > 2147483647LL) return -1;
  const size_t smem =
      (size_t)LU_SOLVE_WARPS * N * (sizeof(double) + sizeof(int));
  lu_solve_kernel<RS><<<(unsigned)grid, LU_SOLVE_WARPS * 32, smem, stream>>>(
      LU, piv, rhs, x, N, B);
  return (int)cudaGetLastError();
}

// The solve: x (B, N) from rhs (B, N) with the factor's LU and piv.
// Returns the launch's cudaError_t, or -1 on a dimension mismatch.
extern "C" int pyjac_lu_solve(const double* LU, const int* piv,
                              const double* rhs, double* x, int N,
                              long long B, void* stream) {
  if (N < 1 || B < 1) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((N + 31) / 32) {
    case 1: return launch_solve<1>(LU, piv, rhs, x, N, B, st);
    case 2: return launch_solve<2>(LU, piv, rhs, x, N, B, st);
    case 3: return launch_solve<3>(LU, piv, rhs, x, N, B, st);
    case 4: return launch_solve<4>(LU, piv, rhs, x, N, B, st);
    case 5: return launch_solve<5>(LU, piv, rhs, x, N, B, st);
    case 6: return launch_solve<6>(LU, piv, rhs, x, N, B, st);
  }
  return -1;
}
