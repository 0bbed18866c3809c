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
// temperature-row sum in one register (`finish_column` in
// csrc/kinetics.cuh, shared with K4).  The same kernel serves K2x, the
// pre-gathered column kernel of the flagship pipeline
// (`_kernel_dd_cols_x`, `SparseJacobian(fuse_gather=False)`).

#include "kinetics.cuh"

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
  finish_column(col_ptr + (size_t)j * N, col_src, col_coef, inv_mw, p1c, post,
                out + (size_t)j * N * B, j, N, conp, B, b);
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
