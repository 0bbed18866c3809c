// Dense Jacobian columns of the large-mechanism pipeline (K7), float64,
// sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py `_kernel_dd_cols`
// (launched from `PallasDDJacobianBig.call_tr` with sparse_cols=False):
// for each reduced-species column j, the dense assembly operand P1_j
// (R, B) built by index comparison from the role array (`_p1_col`: the
// forward-slot values of the reactions whose slot species is j, minus the
// product-slot ones, plus psi_q * eff_m1[:, j] and xi_q where j is the
// pdep species), its contraction with nu_net over all R
// (`_column_block_dd`), the 1/W_j scale and `_post_col`.  Output: the
// columns 1..J as out (J, N, B).  Its plain PyTorch version is
// `cols_dense_reference` in pyjac_tpu_torch/ops/jacobian_big.py.
//
// What bounds it on this card: f64 operations, 2*J*N*R*B for the dense
// contraction (1.2e12 at the 654-species class and B = 512), against a
// few GB of output.
//
// What the design does about it, simply for now: a shared-memory tiled
// product.  A block owns one column j and a 64-row x 64-state tile of
// its output; it walks R in chunks of 16, staging the 16 x 64 slice of
// nu_net and the 16 x 64 slice of P1_j, which it assembles itself (a
// warp shares one reaction, so the slot comparisons are uniform and the
// role values are loaded only where a slot matches).  Each of its 256
// threads keeps 4 x 4 sums in registers.  The temperature row sums over
// all N rows, which span several blocks: each block writes its partial
// sum to `tpart`, and a second kernel adds them in a fixed order.

#include <cuda_runtime.h>

#define TN 64       // output rows per block
#define TB 64       // states per block
#define KC 16       // reactions per chunk
#define THREADS 256

#define AT(arr, r) (arr)[(size_t)(r) * (size_t)B + (size_t)b]

__global__ void __launch_bounds__(THREADS)
big_cols_dense_kernel(const double* __restrict__ nu_net,
                      const int* __restrict__ spf, const int* __restrict__ spp,
                      const double* __restrict__ eff,
                      const int* __restrict__ pd,
                      const double* __restrict__ inv_mw,
                      const double* __restrict__ roles,
                      const double* __restrict__ post,
                      double* __restrict__ out, double* __restrict__ tpart,
                      int N, int R, int Sf, int Sp, int conp, long long B) {
  __shared__ double As[KC][TN];
  __shared__ double Ps[KC][TB];
  __shared__ double red[THREADS / 16][TB];
  const int j = blockIdx.z;
  const int n0 = blockIdx.x * TN;
  const long long b0 = (long long)blockIdx.y * TB;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int J = N - 1;
  const double* psi_q = roles + (size_t)(Sf + Sp + 4) * R * B;
  const double* xi_q = roles + (size_t)(Sf + Sp + 5) * R * B;

  double acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int m = 0; m < 4; ++m) acc[i][m] = 0.0;

  for (int r0 = 0; r0 < R; r0 += KC) {
    for (int q = 0; q < KC * TN / THREADS; ++q) {
      const int e = t + THREADS * q;
      const int rl = e / TN, cl = e % TN;
      const int r = r0 + rl;
      As[rl][cl] = (r < R && n0 + cl < N) ? nu_net[(size_t)r * N + n0 + cl]
                                          : 0.0;
      const long long b = b0 + cl;
      double p = 0.0;
      if (r < R && b < B) {
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
      Ps[rl][cl] = p;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      double a[4], pv[4];
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
      for (int m = 0; m < 4; ++m) pv[m] = Ps[k][tx + 16 * m];
      for (int i = 0; i < 4; ++i)
        for (int m = 0; m < 4; ++m) acc[i][m] = acc[i][m] + a[i] * pv[m];
    }
    __syncthreads();
  }

  // --- _post_col on this tile; partial temperature-row sums -----------------
  const double w_j = inv_mw[j];
  const double u_j = w_j - inv_mw[N - 1];
  const double* v_u = post;
  const double* v_c = post + (size_t)N * B;
  const double* eWn = post + (size_t)2 * N * B;
  const double* fkJ = post + (size_t)4 * N * B;
  const double* mr = post + (size_t)(4 * N + J) * B;
  double* col = out + (size_t)j * N * B;
  for (int m = 0; m < 4; ++m) {
    const long long b = b0 + tx + 16 * m;
    double tp = 0.0;
    if (b < B) {
      const double mw_avg = AT(post, 4 * N + 2 * J + 1);
      const double r_j = conp ? -(mw_avg * u_j) : 0.0;
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + ty * 4 + i;
        if (n >= N) break;
        const double dcol = acc[i][m] * w_j + AT(v_u, n) * u_j + AT(v_c, n);
        tp = tp + AT(eWn, n) * dcol;
        if (n < J) AT(col, 1 + n) = AT(mr, n) * dcol - AT(fkJ, n) * r_j;
      }
    }
    red[ty][tx + 16 * m] = tp;
  }
  __syncthreads();
  if (t < TB) {
    const long long b = b0 + t;
    if (b < B) {
      double s = 0.0;
      for (int y = 0; y < THREADS / 16; ++y) s = s + red[y][t];
      tpart[((size_t)blockIdx.x * J + j) * (size_t)B + (size_t)b] = s;
    }
  }
}

// the temperature row of every column from the blocks' partial sums
__global__ void __launch_bounds__(128)
big_cols_dense_trow(const double* __restrict__ inv_mw,
                    const double* __restrict__ post,
                    const double* __restrict__ tpart,
                    double* __restrict__ out, int N, int n_tiles, int conp,
                    long long B) {
  const int j = blockIdx.x;
  const long long b = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int J = N - 1;
  const double* cpr = post + (size_t)3 * N * B;
  const double ish = AT(post, 4 * N + 2 * J);
  const double mw_avg = AT(post, 4 * N + 2 * J + 1);
  const double fT = AT(post, 4 * N + 2 * J + 2);
  const double u_j = inv_mw[j] - inv_mw[N - 1];
  const double r_j = conp ? -(mw_avg * u_j) : 0.0;
  double tsum = 0.0;
  for (int k = 0; k < n_tiles; ++k) tsum = tsum + AT(tpart, (size_t)k * J + j);
  out[(size_t)j * N * B + (size_t)b] =
      -tsum - fT * (r_j + (AT(cpr, j) - AT(cpr, N - 1)) * ish);
}

extern "C" int pyjac_big_cols_dense_tiles(int N) { return (N + TN - 1) / TN; }

// nu_net (R, N), spf (R, Sf) / spp (R, Sp) slot species (-1 on empty
// slots), eff (R, N), pd (R,), roles (Sf + Sp + 6, R, B), post rows;
// out (N-1, N, B); tpart (tiles(N), N-1, B) scratch.  Returns the first
// failing launch's cudaError_t (0 on success), or -1 when the batch or
// the column count does not fit the grid.
extern "C" int pyjac_big_cols_dense(const double* nu_net, const int* spf,
                                    const int* spp, const double* eff,
                                    const int* pd, const double* inv_mw,
                                    const double* roles, const double* post,
                                    double* out, double* tpart, int N, int R,
                                    int Sf, int Sp, int conp, long long B,
                                    void* stream) {
  const long long btiles = (B + TB - 1) / TB;
  const long long tiles128 = (B + 127) / 128;
  if (btiles > 65535 || tiles128 > 65535 || N < 2 || N - 1 > 65535)
    return -1;
  const int ntiles = (N + TN - 1) / TN;
  dim3 grid((unsigned)ntiles, (unsigned)btiles, (unsigned)(N - 1));
  big_cols_dense_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      nu_net, spf, spp, eff, pd, inv_mw, roles, post, out, tpart, N, R, Sf,
      Sp, conp, B);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid2((unsigned)(N - 1), (unsigned)tiles128);
  big_cols_dense_trow<<<grid2, 128, 0, (cudaStream_t)stream>>>(
      inv_mw, post, tpart, out, N, ntiles, conp, B);
  return (int)cudaGetLastError();
}
