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
// pyjac_tpu_torch/ops/jacobian_big.py.  The same kernel serves K2x, the
// pre-gathered column kernel of the flagship pipeline
// (`_kernel_dd_cols_x`, `SparseJacobian(fuse_gather=False)`; plain
// version `stage_b_reference`).
//
// What bounds it on this card: bytes.  Per state and column it does ~2
// flops per stoichiometric nonzero and ~6 per output row, against N
// doubles written; at the 654-species class and B = 1024 the output is
// 3.5 GB.
//
// What the design does about it.  Read one thread per (state, column),
// the finish re-reads five column-independent post rows per output row
// from L2 (17.5 GB at the 654 class).  Here a block owns G columns x 32
// SPL states (csrc/columns.cuh) and walks the output rows in tiles whose
// post rows and row pointers it stages once for all G columns,
// double-buffered with cp.async; each lane keeps SPL states' sums in
// flight, which hides the operand loads of the CSR walk.  The operand
// stays in device memory, read through L1: staging a column's Rmax rows
// in shared memory, prefetching them into L2, or gathering each tile's
// operand values with cp.async all measured slower (PERF.md), because
// the shared memory they take cuts the warps in flight.  The column
// group is the fastest grid index, so the blocks of one state tile run
// close together and share the post rows in L2.

#include "kinetics.cuh"
#include "columns.cuh"

// G columns per block, TN rows per tile, STAGES tiles in flight, SPL
// states per lane
template <int G, int TN, int STAGES, int SPL>
__global__ void __launch_bounds__(G * WARP)
big_cols_sparse_kernel(const int* __restrict__ col_ptr,
                       const int* __restrict__ col_src,
                       const double* __restrict__ col_coef,
                       const double* __restrict__ inv_mw,
                       const double* __restrict__ p1c,
                       const double* __restrict__ post,
                       double* __restrict__ out, int N, int Rmax, int conp,
                       long long B) {
  extern __shared__ __align__(16) double smem[];
  const int j0 = blockIdx.x * G, j = j0 + threadIdx.x / WARP;
  const long long b0 = (long long)blockIdx.y * WARP * SPL;
  const bool col_ok = j < N - 1;
  finish_column_tiled<G, TN, STAGES, SPL>(
      col_ptr, col_src, col_coef, (col_ok ? j : 0) * Rmax,
      p1c + (size_t)(col_ok ? j : 0) * Rmax * B + b0, B, (char*)smem, post,
      inv_mw, out, j0, N, conp, B, b0);
}

template <int G, int TN, int STAGES, int SPL>
int launch_cols_sparse(const int* col_ptr, const int* col_src,
                       const double* col_coef, const double* inv_mw,
                       const double* p1c, const double* post, double* out,
                       int N, int Rmax, int conp, long long B, void* stream) {
  const long long tiles = (B + WARP * SPL - 1) / (WARP * SPL);
  if (tiles > 65535 || N < 2 || Rmax < 1) return -1;
  const size_t smem = column_smem_bytes<G, TN, STAGES, SPL>(0);
  auto kernel = big_cols_sparse_kernel<G, TN, STAGES, SPL>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  dim3 grid((unsigned)((N - 1 + G - 1) / G), (unsigned)tiles);
  kernel<<<grid, G * WARP, smem, (cudaStream_t)stream>>>(
      col_ptr, col_src, col_coef, inv_mw, p1c, post, out, N, Rmax, conp, B);
  return (int)cudaGetLastError();
}

// col_ptr ((N-1)*N + 1), col_src / col_coef the CSR of nuc over the
// rows of p1c ((N-1)*Rmax, B), column j's entries on its rows
// [j*Rmax, (j+1)*Rmax); out (N-1, N, B).  Returns the launch's
// cudaError_t (0 on success), or -1 when the batch does not fit the
// grid.
extern "C" int pyjac_big_cols_sparse(const int* col_ptr, const int* col_src,
                                     const double* col_coef,
                                     const double* inv_mw, const double* p1c,
                                     const double* post, double* out, int N,
                                     int Rmax, int conp, long long B,
                                     void* stream) {
  // the configuration launched, chosen by timing on the card (PERF.md)
  return launch_cols_sparse<8, 8, 2, 4>(col_ptr, col_src, col_coef, inv_mw,
                                        p1c, post, out, N, Rmax, conp, B,
                                        stream);
}
