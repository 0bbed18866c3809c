// Variants of the stage-A kernel K1 for probes/stage_a_kernels.py: K1's
// own body (stage_a_block, pyjac_tpu_torch/csrc/sparse_stage_a.cu) at W
// warps per 32 states, in a kernel that asks the register allocator for a
// minimum of MINB blocks per SM (the launcher's kernel runs W = 4 and
// names no minimum).  Every variant computes what K1 computes, in the
// same order, so its outputs are bit-equal to K1's.

#include "../pyjac_tpu_torch/csrc/sparse_stage_a.cu"

template <bool HAS_PM, int W, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
k1_variant(StageATables t, PartsDims<double> d, int has_spec, int S_eff,
           const double* __restrict__ y, const double* __restrict__ Pin,
           long long B, double* __restrict__ src, double* __restrict__ col0,
           double* __restrict__ fout, double* __restrict__ post,
           double* __restrict__ scratch) {
  stage_a_block<HAS_PM, W>(t, d, has_spec, S_eff, y, Pin, B, src, col0, fout,
                           post, scratch);
}

template <int W, int MINB>
static int launch(const StageATables& t, const PartsDims<double>& d,
                  int has_pm, int has_spec, int S_eff, const double* y,
                  const double* P, long long B, double* src, double* col0,
                  double* f, double* post, double* scratch,
                  cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + 31) / 32);
  dim3 block(32, W);
  if (has_pm)
    k1_variant<true, W, MINB><<<blocks, block, 0, stream>>>(
        t, d, has_spec, S_eff, y, P, B, src, col0, f, post, scratch);
  else
    k1_variant<false, W, MINB><<<blocks, block, 0, stream>>>(
        t, d, has_spec, S_eff, y, P, B, src, col0, f, post, scratch);
  return (int)cudaGetLastError();
}

// the variants, by index: (W, MINB)
#define N_VARIANTS 4
static const int VARIANTS[N_VARIANTS][2] = {{4, 1}, {8, 1}, {4, 5}, {8, 2}};

extern "C" int k1v_count(void) { return N_VARIANTS; }

extern "C" void k1v_config(int v, int* out) {
  for (int i = 0; i < 2; ++i) out[i] = VARIANTS[v][i];
}

// variant v of K1 with pyjac_stage_a's arguments
extern "C" int k1v_launch(int v, const void* const* tables, const int* dims,
                          double ln_pa_ru, const double* y, const double* P,
                          long long B, double* src, double* col0, double* f,
                          double* post, double* scratch, void* stream) {
  StageATables t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<double> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = 0; d.rows = dims[1];
  d.ln_pa_ru = ln_pa_ru;
  cudaStream_t s = (cudaStream_t)stream;
#define L(W, M) \
  launch<W, M>(t, d, dims[9], dims[10], dims[11], y, P, B, src, col0, f, \
               post, scratch, s)
  switch (v) {
    case 0: return L(4, 1);
    case 1: return L(8, 1);
    case 2: return L(4, 5);
    case 3: return L(8, 2);
  }
#undef L
  return -1;
}
