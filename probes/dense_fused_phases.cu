// Phase cuts of the dense fused kernels K4 (double) and K3 (float) for
// probes/dense_fused_phases.py: the launcher's own kernel template
// (pyjac_tpu_torch/csrc/dense_fused.cu, included, not copied) launched
// through its own `launch<S, LAST>` with the kernel stopping after phase
// LAST: 1 the state and thermo, 2 the reaction parts, 3 the
// stoichiometric contractions, 4 the closure, 5 the columns (the
// launcher's kernel).  Each cut takes the C entry's arguments.

#include "../pyjac_tpu_torch/csrc/dense_fused.cu"

template <typename S>
static int upto(int last, DENSE_FUSED_PARAMS(S)) {
  switch (last) {
    case 1: return launch<S, 1>(DENSE_FUSED_ARGS);
    case 2: return launch<S, 2>(DENSE_FUSED_ARGS);
    case 3: return launch<S, 3>(DENSE_FUSED_ARGS);
    case 4: return launch<S, 4>(DENSE_FUSED_ARGS);
    case 5: return launch<S, 5>(DENSE_FUSED_ARGS);
  }
  return -1;
}

// K4 / K3 cut after phase `last`, with pyjac_dense_fused's /
// pyjac_fused_f32's arguments
extern "C" int dfp_f64(int last, DENSE_FUSED_PARAMS(double)) {
  return upto<double>(last, DENSE_FUSED_ARGS);
}

extern "C" int dfp_f32(int last, DENSE_FUSED_PARAMS(float)) {
  return upto<float>(last, DENSE_FUSED_ARGS);
}

// J's store pattern alone: block i writes the values of states [i TS,
// (i + 1) TS) of every (column, row) of Jt (N, N, B) -- TS consecutive
// values per row, as a tile of K4 / K3 does -- with `smem` bytes of
// dynamic shared memory held, so as many blocks share an SM as the
// kernel's would (the launch reserves them).  No arithmetic: what the
// stores alone cost.
template <typename S>
__global__ void __launch_bounds__(512) store_pattern(S* __restrict__ Jt,
                                                     long long B, int N,
                                                     int TS) {
  const long long b0 = (long long)blockIdx.x * TS;
  const int live = (int)(B - b0 < TS ? B - b0 : TS);
  for (int e = threadIdx.x; e < N * N * TS; e += blockDim.x) {
    const int s = e % TS, cr = e / TS;
    if (s < live) Jt[(size_t)cr * B + b0 + s] = S(cr);
  }
}

template <typename S>
static int run_store_pattern(S* Jt, long long B, int N, int TS, int threads,
                             int smem, void* stream) {
  auto k = store_pattern<S>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k<<<(unsigned)((B + TS - 1) / TS), threads, smem, (cudaStream_t)stream>>>(
      Jt, B, N, TS);
  return (int)cudaGetLastError();
}

extern "C" int dfp_store_f64(double* Jt, long long B, int N, int TS,
                             int threads, int smem, void* stream) {
  return run_store_pattern<double>(Jt, B, N, TS, threads, smem, stream);
}

extern "C" int dfp_store_f32(float* Jt, long long B, int N, int TS,
                             int threads, int smem, void* stream) {
  return run_store_pattern<float>(Jt, B, N, TS, threads, smem, stream);
}
