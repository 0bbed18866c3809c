// Sparse Jacobian columns of the large-mechanism pipeline (K6), float64,
// sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py
// `_kernel_dd_cols_sparse` (launched from `PallasDDJacobianBig.call_tr`,
// once per Rmax class; here all columns form one class): for each
// column j, the contraction of its pre-assembled operand block
// p1c[j*Rmax:(j+1)*Rmax] (the gathered source rows, `_p1c_from_parts`)
// with its signed stoichiometry nuc[j] (N x Rmax), the 1/W_j scale and
// `_post_col`, into out[j] of the (J, N, B) column array.  Its plain
// PyTorch version is `cols_sparse_reference` in
// pyjac_tpu_torch/ops/jacobian_big.py.
//
// What bounds it on this card: bytes.  Per state and column it does ~2
// flops per stoichiometric nonzero and ~6 per output row, against N
// doubles written; at the 654-species class and B = 1024 the output is
// 3.5 GB.
//
// What the design does about it: K2's (csrc/sparse_stage_b.cu).  One
// thread per (state, column), states fastest, so every load and store of
// a warp is 32 consecutive doubles; the column is the fastest block
// index, so the blocks of one state tile share its post rows in L2; the
// thread walks nuc[j] as a CSR over species rows (the operand row of
// each nonzero stored directly), finishes each row at once and keeps the
// temperature-row sum in one register.

#include <cuda_runtime.h>

#define AT(arr, r) (arr)[(size_t)(r) * (size_t)B + (size_t)b]

__global__ void __launch_bounds__(128)
big_cols_sparse_kernel(const int* __restrict__ col_ptr,
                       const int* __restrict__ col_src,
                       const double* __restrict__ col_coef,
                       const double* __restrict__ inv_mw,
                       const double* __restrict__ p1c,
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
      acc += col_coef[e] * AT(p1c, col_src[e]);
    const double dcol = acc * w_j + AT(v_u, n) * u_j + AT(v_c, n);
    tsum += AT(eWn, n) * dcol;
    if (n < J) AT(col, 1 + n) = AT(mr, n) * dcol - AT(fkJ, n) * r_j;
  }
  AT(col, 0) = -tsum - fT * (r_j + (AT(cpr, j) - AT(cpr, N - 1)) * ish);
}

// col_ptr ((N-1)*N + 1), col_src / col_coef the CSR of nuc over the
// rows of p1c ((N-1)*Rmax, B); out (N-1, N, B).  Returns the launch's
// cudaError_t (0 on success), or -1 when the batch does not fit the
// grid.
extern "C" int pyjac_big_cols_sparse(const int* col_ptr, const int* col_src,
                                     const double* col_coef,
                                     const double* inv_mw, const double* p1c,
                                     const double* post, double* out, int N,
                                     int conp, long long B, void* stream) {
  const int threads = 128;
  const long long tiles = (B + threads - 1) / threads;
  if (tiles > 65535 || N < 2) return -1;
  dim3 grid((unsigned)(N - 1), (unsigned)tiles);
  big_cols_sparse_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      col_ptr, col_src, col_coef, inv_mw, p1c, post, out, N, conp, B);
  return (int)cudaGetLastError();
}
