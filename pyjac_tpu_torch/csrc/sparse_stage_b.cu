// Stage B of the compressed sparse Jacobian pipeline, float64, sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py
// `_kernel_dd_cols_fused` (launched from
// `PallasDDJacobianSparse.stage_b_fused`): for each reduced-species
// column j, the contraction of the column's role rows of the source
// array with its signed stoichiometry nuc[j] (N x Rmax), the 1/W_j
// scale, and `_post_col` (the rank-one mean-molecular-weight terms and
// the temperature row).  Output: the Jacobian columns 1..J as
// out (J, N, B), out[j, 0] = d(dT/dt)/dY_j, out[j, 1+k] = d(dY_k/dt)/dY_j.
// Its plain PyTorch version is `stage_b_reference` in
// pyjac_tpu_torch/ops/jacobian_sparse.py.
//
// What bounds it on this card: bytes.  Per state and column it does
// ~2 flops per stoichiometric nonzero (4553 over all 52 flagship
// columns) and ~6 per output row, while it writes J*N doubles (22 KB
// per state) and reads each column's Rmax source rows plus six
// column-finishing rows: at B = 131072 about 2.9 GB written and, if
// nothing is reused from cache, ~3 GB of source rows and ~14 GB of
// finishing rows read.
//
// What the design does about it: one thread per (state, column), states
// fastest, so every load and store of a warp is 32 consecutive doubles.
// The column is the fastest grid index (blockIdx.x = j), so the J blocks
// that share one tile of states run close together in time and find that
// tile's source and finishing rows in L2 instead of device memory.  The
// thread walks nuc[j] as a CSR over species rows n (col_ptr/col_src/
// col_coef: the source row of each nonzero is stored directly, so there
// is no gidx indirection), finishes row n at once and accumulates the
// temperature-row sum in one register, so no N-long array is kept.

#include <cuda_runtime.h>

#define AT(arr, r) (arr)[(size_t)(r) * (size_t)B + (size_t)b]

__global__ void __launch_bounds__(128)
sparse_stage_b_kernel(const int* __restrict__ col_ptr,
                      const int* __restrict__ col_src,
                      const double* __restrict__ col_coef,
                      const double* __restrict__ inv_mw,
                      const double* __restrict__ src,
                      const double* __restrict__ post,
                      double* __restrict__ out, int N, int conp,
                      long long B) {
  const int j = blockIdx.x;
  const long long b = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int J = N - 1;

  // post rows (jacobian_sparse.post_rows)
  const double* v_u = post;
  const double* v_c = post + (size_t)N * B;
  const double* eWn = post + (size_t)2 * N * B;
  const double* cpr = post + (size_t)3 * N * B;
  const double* fkJ = post + (size_t)4 * N * B;
  const double* mr = post + (size_t)(4 * N + J) * B;
  const double ish = AT(post, 4 * N + 2 * J);
  const double mw_avg = AT(post, 4 * N + 2 * J + 1);
  const double fT = AT(post, 4 * N + 2 * J + 2);

  const double w_j = inv_mw[j];
  const double u_j = w_j - inv_mw[N - 1];
  const double r_j = conp ? -(mw_avg * u_j) : 0.0;
  double* col = out + (size_t)j * N * B;

  const int* ptr = col_ptr + (size_t)j * N;
  double tsum = 0.0;
  for (int n = 0; n < N; ++n) {
    double acc = 0.0;
    for (int e = ptr[n]; e < ptr[n + 1]; ++e)
      acc += col_coef[e] * AT(src, col_src[e]);
    const double dcol = acc * w_j + AT(v_u, n) * u_j + AT(v_c, n);
    tsum += AT(eWn, n) * dcol;
    if (n < J) AT(col, 1 + n) = AT(mr, n) * dcol - AT(fkJ, n) * r_j;
  }
  AT(col, 0) = -tsum - fT * (r_j + (AT(cpr, j) - AT(cpr, N - 1)) * ish);
}

// Returns the launch's cudaError_t (0 on success), or -1 when the batch
// does not fit the grid.
extern "C" int pyjac_stage_b(const int* col_ptr, const int* col_src,
                             const double* col_coef, const double* inv_mw,
                             const double* src, const double* post,
                             double* out, int N, int conp, long long B,
                             void* stream) {
  const int threads = 128;
  const long long tiles = (B + threads - 1) / threads;
  if (tiles > 65535 || N < 2) return -1;
  dim3 grid((unsigned)(N - 1), (unsigned)tiles);
  sparse_stage_b_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      col_ptr, col_src, col_coef, inv_mw, src, post, out, N, conp, B);
  return (int)cudaGetLastError();
}
