// Three versions of the one-thread-per-(state, column) column kernel that
// K6 and K2x ran before their redesign (csrc/big_cols_sparse.cu), for
// probes/column_kernels.py: `orig` is that kernel (finish_column of
// csrc/kinetics.cuh on a 128-thread block), (a) the same with the five
// post rows of every output row replaced by one state's values held in
// registers, (b) the same without the CSR contraction.  (a) and (b)
// compute wrong columns on purpose: they time what each part costs.
#include "kinetics.cuh"

// (a) post rows held in registers: one state's values read once
template <typename S>
__device__ __forceinline__ void finish_a(
    const int* __restrict__ ptr, const int* __restrict__ col_src,
    const S* __restrict__ col_coef, const S* __restrict__ inv_mw,
    const S* __restrict__ operand, const S* __restrict__ post,
    S* __restrict__ col, int j, int N, int conp, long long B, long long b) {
  const int J = N - 1;
  const S* v_u = post;
  const S* v_c = post + (size_t)N * B;
  const S* eWn = post + (size_t)2 * N * B;
  const S* cpr = post + (size_t)3 * N * B;
  const S* fkJ = post + (size_t)4 * N * B;
  const S* mr = post + (size_t)(4 * N + J) * B;
  const S ish = AT(post, 4 * N + 2 * J);
  const S mw_avg = AT(post, 4 * N + 2 * J + 1);
  const S fT = AT(post, 4 * N + 2 * J + 2);
  const S vu0 = AT(v_u, 0), vc0 = AT(v_c, 0), e0 = AT(eWn, 0), m0 = AT(mr, 0),
          f0 = AT(fkJ, 0);
  const S w_j = inv_mw[j];
  const S u_j = w_j - inv_mw[N - 1];
  const S r_j = conp ? -(mw_avg * u_j) : S(0);
  S tsum = S(0);
  for (int n = 0; n < N; ++n) {
    S acc = S(0);
    for (int e = ptr[n]; e < ptr[n + 1]; ++e)
      acc += col_coef[e] * AT(operand, col_src[e]);
    const S dcol = acc * w_j + vu0 * u_j + vc0;
    tsum += e0 * dcol;
    if (n < J) AT(col, 1 + n) = m0 * dcol - f0 * r_j;
  }
  AT(col, 0) = -tsum - fT * (r_j + (AT(cpr, j) - AT(cpr, N - 1)) * ish);
}

// (b) no CSR contraction
template <typename S>
__device__ __forceinline__ void finish_b(
    const int* __restrict__ ptr, const int* __restrict__ col_src,
    const S* __restrict__ col_coef, const S* __restrict__ inv_mw,
    const S* __restrict__ operand, const S* __restrict__ post,
    S* __restrict__ col, int j, int N, int conp, long long B, long long b) {
  const int J = N - 1;
  const S* v_u = post;
  const S* v_c = post + (size_t)N * B;
  const S* eWn = post + (size_t)2 * N * B;
  const S* cpr = post + (size_t)3 * N * B;
  const S* fkJ = post + (size_t)4 * N * B;
  const S* mr = post + (size_t)(4 * N + J) * B;
  const S ish = AT(post, 4 * N + 2 * J);
  const S mw_avg = AT(post, 4 * N + 2 * J + 1);
  const S fT = AT(post, 4 * N + 2 * J + 2);
  const S w_j = inv_mw[j];
  const S u_j = w_j - inv_mw[N - 1];
  const S r_j = conp ? -(mw_avg * u_j) : S(0);
  S tsum = S(0);
  for (int n = 0; n < N; ++n) {
    const S dcol = AT(v_u, n) * u_j + AT(v_c, n);
    tsum += AT(eWn, n) * dcol;
    if (n < J) AT(col, 1 + n) = AT(mr, n) * dcol - AT(fkJ, n) * r_j;
  }
  AT(col, 0) = -tsum - fT * (r_j + (AT(cpr, j) - AT(cpr, N - 1)) * ish);
}

#define VARIANT(NAME, BODY)                                                    \
  __global__ void __launch_bounds__(128) k_##NAME(                             \
      const int* __restrict__ col_ptr, const int* __restrict__ col_src,        \
      const double* __restrict__ col_coef, const double* __restrict__ inv_mw,  \
      const double* __restrict__ p1c, const double* __restrict__ post,         \
      double* __restrict__ out, int N, int conp, long long B) {                \
    const int j = blockIdx.x;                                                  \
    const long long b = (long long)blockIdx.y * blockDim.x + threadIdx.x;      \
    if (b >= B) return;                                                        \
    BODY(col_ptr + (size_t)j * N, col_src, col_coef, inv_mw, p1c, post,        \
         out + (size_t)j * N * B, j, N, conp, B, b);                           \
  }                                                                            \
  extern "C" int v_##NAME(const int* col_ptr, const int* col_src,              \
                          const double* col_coef, const double* inv_mw,        \
                          const double* p1c, const double* post, double* out,  \
                          int N, int conp, long long B, void* stream) {        \
    dim3 grid((unsigned)(N - 1), (unsigned)((B + 127) / 128));                 \
    k_##NAME<<<grid, 128, 0, (cudaStream_t)stream>>>(                          \
        col_ptr, col_src, col_coef, inv_mw, p1c, post, out, N, conp, B);       \
    return (int)cudaGetLastError();                                            \
  }

VARIANT(orig, finish_column)
VARIANT(a, finish_a)
VARIANT(b, finish_b)
