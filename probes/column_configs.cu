// The redesigned column kernels K6/K2x (csrc/big_cols_sparse.cu) and K7
// (csrc/big_cols_dense.cu) at several block configurations, for
// probes/column_kernels.py: G columns per block, TN rows per tile, STAGES
// tiles in flight, SPL states per lane.  Each configuration has a launch
// entry, its blocks per SM and its shared memory per block.

#include "big_cols_sparse.cu"
#include "big_cols_dense.cu"

#define KS(NAME, G, TN, S, P)                                                  \
  extern "C" int ks_##NAME(const int* a, const int* b, const double* c,        \
                           const double* d, const double* e, const double* f,  \
                           double* o, int N, int Rmax, int conp, long long B,  \
                           void* s) {                                          \
    return launch_cols_sparse<G, TN, S, P>(a, b, c, d, e, f, o, N, Rmax, conp, \
                                           B, s);                              \
  }                                                                            \
  extern "C" int occs_##NAME(int rows) {                                       \
    int n = -1;                                                                \
    size_t smem = column_smem_bytes<G, TN, S, P>(0);                           \
    allow_smem(big_cols_sparse_kernel<G, TN, S, P>, smem);                     \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                             \
        &n, big_cols_sparse_kernel<G, TN, S, P>, G * WARP, smem);              \
    return n;                                                                  \
  }                                                                            \
  extern "C" long long smems_##NAME(int rows) {                                \
    return (long long)column_smem_bytes<G, TN, S, P>(0);                       \
  }

#define KD(NAME, G, TN, S, P)                                                  \
  extern "C" int kd_##NAME(                                                    \
      const int* act, const int* p, const int* sr, const double* cf,           \
      const int* spf, const int* spp, const double* eff, const int* pd,        \
      const double* w, const double* roles, const double* post, double* out,   \
      int N, int R, int Sf, int Sp, int A, int conp, long long B, void* s) {   \
    return launch_cols_dense<G, TN, S, P>(act, p, sr, cf, spf, spp, eff, pd,   \
                                          w, roles, post, out, N, R, Sf, Sp,   \
                                          A, conp, B, s);                      \
  }                                                                            \
  extern "C" int occd_##NAME(int rows) {                                       \
    int n = -1;                                                                \
    size_t smem = column_smem_bytes<G, TN, S, P>(rows);                        \
    allow_smem(big_cols_dense_kernel<G, TN, S, P>, smem);                      \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                             \
        &n, big_cols_dense_kernel<G, TN, S, P>, G * WARP, smem);               \
    return n;                                                                  \
  }                                                                            \
  extern "C" long long smemd_##NAME(int rows) {                                \
    return (long long)column_smem_bytes<G, TN, S, P>(rows);                    \
  }

// K6 / K2x; g8t8s2p4 is the configuration launched
KS(g8t8s2p4, 8, 8, 2, 4)
KS(g8t16s2p1, 8, 16, 2, 1)
KS(g8t8s2p2, 8, 8, 2, 2)
KS(g8t8s3p2, 8, 8, 3, 2)
KS(g16t8s2p2, 16, 8, 2, 2)
KS(g4t8s2p4, 4, 8, 2, 4)
KS(g8t16s2p4, 8, 16, 2, 4)
// K7; g16t16s2p1 is the configuration launched at the 654 class
KD(g16t16s2p1, 16, 16, 2, 1)
KD(g8t16s2p1, 8, 16, 2, 1)
KD(g8t8s2p1, 8, 8, 2, 1)
KD(g4t8s2p2, 4, 8, 2, 2)
