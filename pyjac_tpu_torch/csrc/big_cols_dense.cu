// Dense-configuration Jacobian columns of the large-mechanism pipeline
// (K7), float64, sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py `_kernel_dd_cols`
// (launched from `PallasDDJacobianBig.call_tr` with sparse_cols=False):
// for each reduced-species column j, the assembly operand P1_j (R, B)
// built from the role array (`_p1_col`: the forward-slot values of the
// reactions whose slot species is j, minus the product-slot ones, plus
// psi_q * eff_m1[:, j] and xi_q where j is the pdep species), its
// contraction with nu_net over R (`_column_block_dd`), the 1/W_j scale and
// `_post_col`.  Output: the columns 1..J as out (J, N, B).  Its plain
// PyTorch version is `cols_dense_reference` in
// pyjac_tpu_torch/ops/jacobian_big.py.
//
// What bounds it on this card: bytes, as K6 (csrc/big_cols_sparse.cu).
// The TPU kernel contracts all R reactions for every column, 2 J N R B
// operations (1.2e12 at the 654-species class and B = 512), but column
// j's operand is nonzero only on the reactions that name j in a slot,
// an efficiency or the pdep index (16 of 2716 on average there), and
// nu_net has ~4 nonzeros per reaction: the function needs 3.6e-5 of
// those operations.  Even at the f64 tensor-core peak the dense product
// would take longer than writing the output, so it is not done on tensor
// cores (nor is any dense product done here).
//
// What the design does about it: the host table `dense_active_tables`
// lists column j's active reactions (ascending, padded to a multiple of
// 8 with -1) and a CSR over output rows n of their nonzero nu_net[r, n]
// (entries in ascending r, so each sum adds exactly the nonzero products
// of the dense contraction, in its order).  Each warp of a block
// assembles its column's active operand rows for 32 states into shared
// memory, in `_p1_col`'s order (slot comparisons are warp-uniform), then
// the block finishes its G columns through the tiled body of
// csrc/columns.cuh, the temperature row in a register: one launch, no
// scratch.

#include "kinetics.cuh"
#include "columns.cuh"

// G columns per block, TN rows per tile, STAGES tiles in flight, SPL
// states per lane
template <int G, int TN, int STAGES, int SPL>
__global__ void __launch_bounds__(G * WARP)
big_cols_dense_kernel(const int* __restrict__ act,
                      const int* __restrict__ col_ptr,
                      const int* __restrict__ col_src,
                      const double* __restrict__ col_coef,
                      const int* __restrict__ spf, const int* __restrict__ spp,
                      const double* __restrict__ eff,
                      const int* __restrict__ pd,
                      const double* __restrict__ inv_mw,
                      const double* __restrict__ roles,
                      const double* __restrict__ post,
                      double* __restrict__ out, int N, int R, int Sf, int Sp,
                      int A, int conp, long long B) {
  constexpr int TB = WARP * SPL;
  extern __shared__ __align__(16) double smem[];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int j0 = blockIdx.x * G, j = j0 + warp;
  const long long b0 = (long long)blockIdx.y * TB;
  const bool col_ok = j < N - 1;
  const double* psi_q = roles + (size_t)(Sf + Sp + 4) * R * B;
  const double* xi_q = roles + (size_t)(Sf + Sp + 5) * R * B;
  double* op = smem + (size_t)warp * A * TB;
  for (int i = 0; i < A; ++i) {
    const int r = col_ok ? act[(size_t)j * A + i] : -1;
    for (int l = lane; l < TB; l += WARP) {
      // states past B assemble state b0's operand and store nothing
      const long long b = b0 + l < B ? b0 + l : b0;
      double p = 0.0;
      if (r >= 0) {
        double sf = 0.0, sp = 0.0;
        for (int s = 0; s < Sf; ++s)
          if (spf[(size_t)r * Sf + s] == j)
            sf = sf + AT(roles, (size_t)s * R + r);
        for (int s = 0; s < Sp; ++s)
          if (spp[(size_t)r * Sp + s] == j)
            sp = sp + AT(roles, (size_t)(Sf + s) * R + r);
        p = sf - sp;
        const double ef = eff[(size_t)r * N + j];
        if (ef != 0.0) p = p + AT(psi_q, r) * ef;
        if (pd[r] == j) p = p + AT(xi_q, r);
      }
      op[i * TB + l] = p;
    }
  }
  finish_column_tiled<G, TN, STAGES, SPL>(
      col_ptr, col_src, col_coef, 0, op, TB,
      (char*)(smem + (size_t)G * A * TB), post, inv_mw, out, j0, N, conp, B,
      b0);
}

template <int G, int TN, int STAGES, int SPL>
int launch_cols_dense(const int* act, const int* col_ptr, const int* col_src,
                      const double* col_coef, const int* spf, const int* spp,
                      const double* eff, const int* pd, const double* inv_mw,
                      const double* roles, const double* post, double* out,
                      int N, int R, int Sf, int Sp, int A, int conp,
                      long long B, void* stream) {
  const long long tiles = (B + WARP * SPL - 1) / (WARP * SPL);
  if (tiles > 65535 || N < 2 || A < 1) return -1;
  const size_t smem = column_smem_bytes<G, TN, STAGES, SPL>(A);
  auto kernel = big_cols_dense_kernel<G, TN, STAGES, SPL>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  dim3 grid((unsigned)((N - 1 + G - 1) / G), (unsigned)tiles);
  kernel<<<grid, G * WARP, smem, (cudaStream_t)stream>>>(
      act, col_ptr, col_src, col_coef, spf, spp, eff, pd, inv_mw, roles, post,
      out, N, R, Sf, Sp, A, conp, B);
  return (int)cudaGetLastError();
}

// act (N-1, A) active reactions per column (-1 pads), col_ptr
// ((N-1)*N + 1), col_src (position in the column's act row) / col_coef
// (nu_net) the CSR over output rows; spf (R, Sf) / spp (R, Sp) slot
// species (-1 on empty slots), eff (R, N), pd (R,), roles
// (Sf + Sp + 6, R, B), post rows; out (N-1, N, B).  Returns the launch's
// cudaError_t (0 on success), or -1 when the batch does not fit the
// grid or one column's operand rows do not fit in shared memory.
extern "C" int pyjac_big_cols_dense(const int* act, const int* col_ptr,
                                    const int* col_src,
                                    const double* col_coef, const int* spf,
                                    const int* spp, const double* eff,
                                    const int* pd, const double* inv_mw,
                                    const double* roles, const double* post,
                                    double* out, int N, int R, int Sf, int Sp,
                                    int A, int conp, long long B,
                                    void* stream) {
  // the configuration launched, chosen by timing on the card (PERF.md):
  // 16 columns per block where their operand rows fit in shared memory
  // (A <= 40), else the widest block that fits
#define COLS_DENSE(G)                                                        \
  if (column_smem_bytes<G, 16, 2, 1>(A) <= SMEM_OPTIN)                       \
    return launch_cols_dense<G, 16, 2, 1>(act, col_ptr, col_src, col_coef,  \
                                          spf, spp, eff, pd, inv_mw, roles, \
                                          post, out, N, R, Sf, Sp, A, conp, \
                                          B, stream);
  COLS_DENSE(16)
  COLS_DENSE(8)
  COLS_DENSE(4)
  COLS_DENSE(1)
#undef COLS_DENSE
  return -1;
}
