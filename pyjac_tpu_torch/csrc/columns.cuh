// The tiled column finish shared by the column kernels K6/K2x
// (csrc/big_cols_sparse.cu) and K7 (csrc/big_cols_dense.cu), float64,
// sm_90a.
//
// A block owns G Jacobian columns x TB = 32 SPL states: warp w finishes
// column j0 + w, lane l states b0 + l + 32 k (k < SPL), so each row
// store of a warp is SPL runs of 256 contiguous bytes, and each lane has
// SPL independent sums in flight.  Per state and column, the finish
// (`_post_col`) reads five column-independent post rows (v_u, v_c, eWn,
// fkJ, mr) for each of the N output rows and writes one double: read by
// every column alone, they cost ~5x the output in L2 traffic.  Here the
// block stages them once for its G columns, in tiles of TN rows, into
// shared memory with asynchronous copies (cp.async through
// <cuda_pipeline.h>), with each column's TN + 1 CSR row pointers of the
// tile, STAGES tiles in flight, so the next tiles load while this one is
// finished: the L2 re-reads fall G-fold, and no row waits on a pointer
// load of its own.
//
// Arithmetic order is `finish_column`'s (csrc/kinetics.cuh), and so the
// plain version's (ops/jacobian_sparse.post_col_reference): per row the
// CSR sum in entry order, dcol = acc w_j + v_u u_j + v_c, the temperature
// row's sum tsum += eWn dcol in ascending n, kept in a register, and the
// temperature row written last.  No second pass, no atomics.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define WARP 32

// the five post rows a row tile stages, in their order in shared memory
// (post_rows: v_u at row 0, v_c at N, eWn at 2N, fkJ at 4N, mr at 4N + J)
#define POST_TILE_ROWS 5

// One stage of the row pipeline in shared memory: the post tile (5, TN,
// TB) doubles, then the G columns' row pointers (G, TN + 1) ints.
template <int G, int TN, int SPL>
struct RowTile {
  static constexpr int TB = WARP * SPL;
  static constexpr int POST = POST_TILE_ROWS * TN * TB;
  static constexpr int PTRS = G * (TN + 1);
  static constexpr size_t BYTES =
      (sizeof(double) * POST + sizeof(int) * PTRS + 15) / 16 * 16;
};

// Shared memory of one block: the G warps' operand rows (op_rows each,
// TB states; 0 when the operand stays in device memory), then STAGES row
// tiles.
template <int G, int TN, int STAGES, int SPL>
inline size_t column_smem_bytes(int op_rows) {
  return sizeof(double) * WARP * SPL * (size_t)G * op_rows +
         (size_t)STAGES * RowTile<G, TN, SPL>::BYTES;
}

// Stage rows [n0, n0 + TN) of the five post rows, states [b0, b0 + TB),
// and the row pointers [n0, n0 + TN] of columns [j0, j0 + G) into one row
// tile; rows past the array, states past B and columns past J read 0.
template <int G, int TN, int SPL>
__device__ __forceinline__ void stage_row_tile(char* tile,
                                               const double* __restrict__ post,
                                               const int* __restrict__ col_ptr,
                                               int j0, int n0, int N,
                                               long long b0, long long B) {
  using T = RowTile<G, TN, SPL>;
  constexpr int NT = G * WARP;
  const int J = N - 1;
  double* pt = (double*)tile;
  for (int e = threadIdx.x; e < T::POST; e += NT) {
    const int q = e / (TN * T::TB);
    const int n = n0 + (e / T::TB) % TN;
    const long long b = b0 + e % T::TB;
    const int row0 = q < 3 ? q * N : (q == 3 ? 4 * N : 4 * N + J);
    if (n < (q < 3 ? N : J) && b < B)
      __pipeline_memcpy_async(pt + e, post + (size_t)(row0 + n) * B + b,
                              sizeof(double));
    else
      pt[e] = 0.0;
  }
  int* pw = (int*)(pt + T::POST);
  for (int e = threadIdx.x; e < T::PTRS; e += NT) {
    const int j = j0 + e / (TN + 1), n = n0 + e % (TN + 1);
    if (j < J && n <= N)
      __pipeline_memcpy_async(pw + e, col_ptr + (size_t)j * N + n,
                              sizeof(int));
    else
      pw[e] = 0;
  }
}

// Finish column j = j0 + warp of the block's states: its operand row i
// at op[i * op_stride + 32 k + lane] for this lane's state k (in shared
// memory, or in device memory from state b0), its CSR (col_ptr: N + 1
// row pointers per column, from column j's at col_ptr + j * N; entries:
// an operand row src[e] - src_base and a coefficient), the post rows and
// the columns' output out (J, N, B).  post_sm: STAGES row tiles in shared
// memory.  Every thread of the block calls it (it synchronises the
// block); the operand must be complete by its first barrier, which
// follows the wait for the first tile's copies (copies of the operand
// issued before the call belong to that group).
template <int G, int TN, int STAGES, int SPL>
__device__ __forceinline__ void finish_column_tiled(
    const int* __restrict__ col_ptr, const int* __restrict__ src,
    const double* __restrict__ coef, int src_base, const double* op,
    long long op_stride, char* post_sm, const double* __restrict__ post,
    const double* __restrict__ inv_mw, double* __restrict__ out, int j0,
    int N, int conp, long long B, long long b0) {
  using T = RowTile<G, TN, SPL>;
  constexpr int TILE = (int)T::BYTES;
  const int J = N - 1;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int j = j0 + warp;
  const bool col_ok = j < J;              // uniform over the warp
  // lane offsets of this lane's states; states past B compute on state
  // b0's values (offset 0) and store nothing
  bool in[SPL];
  int ln[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    in[k] = b0 + WARP * k + lane < B;
    ln[k] = in[k] ? WARP * k + lane : 0;
  }
  const int ntile = (N + TN - 1) / TN;
  double* col = out + (size_t)(col_ok ? j : 0) * N * B + b0;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntile)
      stage_row_tile<G, TN, SPL>(post_sm + s * TILE, post, col_ptr, j0,
                                 s * TN, N, b0, B);
    __pipeline_commit();
  }

  double w_j = 0.0, u_j = 0.0, r_j[SPL], tsum[SPL];
  if (col_ok) {
    w_j = inv_mw[j];
    u_j = w_j - inv_mw[N - 1];
  }
  const double* mw_avg = post + (size_t)(4 * N + 2 * J + 1) * B + b0;
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    r_j[k] = conp && col_ok ? -(mw_avg[ln[k]] * u_j) : 0.0;
    tsum[k] = 0.0;
  }
  for (int t = 0; t < ntile; ++t) {
    // tile t has landed once at most STAGES - 2 later groups are pending;
    // after the barrier no thread still reads the tile refilled next
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    const int nt = t + STAGES - 1;
    if (nt < ntile)
      stage_row_tile<G, TN, SPL>(post_sm + (nt % STAGES) * TILE, post,
                                 col_ptr, j0, nt * TN, N, b0, B);
    __pipeline_commit();
    if (!col_ok) continue;
    const double* pt = (const double*)(post_sm + (t % STAGES) * TILE) + lane;
    const int* pw = (const int*)(post_sm + (t % STAGES) * TILE +
                                 sizeof(double) * T::POST) +
                    warp * (TN + 1);
    const int n0 = t * TN;
    const int rows = N - n0 < TN ? N - n0 : TN;
    for (int i = 0; i < rows; ++i) {
      const int n = n0 + i;
      double acc[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) acc[k] = 0.0;
      for (int e = pw[i]; e < pw[i + 1]; ++e) {
        const double c = coef[e];
        const double* o = op + (long long)(src[e] - src_base) * op_stride;
#pragma unroll
        for (int k = 0; k < SPL; ++k) acc[k] += c * o[ln[k]];
      }
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const double* p = pt + WARP * k;
        const double dcol = acc[k] * w_j + p[i * T::TB] * u_j +
                            p[(TN + i) * T::TB];
        tsum[k] += p[(2 * TN + i) * T::TB] * dcol;
        if (in[k] && n < J)
          col[(size_t)(1 + n) * B + WARP * k + lane] =
              p[(4 * TN + i) * T::TB] * dcol - p[(3 * TN + i) * T::TB] * r_j[k];
      }
    }
  }
  if (col_ok) {
    const double* cpr = post + (size_t)3 * N * B + b0;
    const double* ish = post + (size_t)(4 * N + 2 * J) * B + b0;
    const double* fT = post + (size_t)(4 * N + 2 * J + 2) * B + b0;
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (in[k])
        col[WARP * k + lane] =
            -tsum[k] - fT[ln[k]] * (r_j[k] + (cpr[(size_t)j * B + ln[k]] -
                                              cpr[(size_t)(N - 1) * B +
                                                  ln[k]]) *
                                                 ish[ln[k]]);
  }
}

// the most dynamic shared memory an sm_90 block may opt into (227 KB)
#define SMEM_OPTIN 232448

// Allow a kernel more than the default 48 KB of dynamic shared memory.
// Returns the cudaError_t of the request, cleared from the runtime's
// last error, or -1 when bytes exceed SMEM_OPTIN.
template <typename K>
inline int allow_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_OPTIN) return -1;
  if (bytes <= 48 * 1024) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err) cudaGetLastError();
  return err;
}
