// Native state-data runtime: binary loading, layout transforms, and
// thermo precomputation for huge thermochemical state batches.
//
// C++ rebuild of the reference's native data-loading layer
// (reference: pyjac/performance_tester/read_initial_conditions.c:29-54
// — AoS loading with species masking and CONV density precompute — and
// read_initial_conditions.cu:42 — the SoA layout variant feeding
// coalesced GPU loads). On TPU the SoA (state-index minor) layout is
// what keeps the batch dimension on VPU lanes; the transpose and the
// density sweep are multi-threaded here so host-side data staging keeps
// up with the device.
//
// Exposed as a plain C ABI consumed via ctypes
// (pyjac_tpu/runtime/stateio.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double RU = 8314.4621;  // J/(kmol K), reference chem_utilities

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = hw ? static_cast<int64_t>(hw) : 1;
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Number of complete rows of `row_width` doubles in a raw binary file
// (the reference's data.bin format: rows of (t, T, P, Y...)).
int64_t stateio_count(const char* path, int64_t row_width) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  int64_t bytes = std::ftell(f);
  std::fclose(f);
  if (bytes < 0 || row_width <= 0) return -1;
  return bytes / (row_width * static_cast<int64_t>(sizeof(double)));
}

// Load up to n rows into `out` (n x row_width, row-major). Returns rows
// actually read, or -1 on error.
int64_t stateio_load(const char* path, int64_t row_width, int64_t n,
                     double* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  size_t want = static_cast<size_t>(n) * row_width;
  size_t got = std::fread(out, sizeof(double), want, f);
  std::fclose(f);
  return static_cast<int64_t>(got / row_width);
}

// Build framework state vectors from raw (t, T, P, Y...) rows:
//  y_out[n, nsp]  = [T, Y_fwd(0) .. Y_fwd(nsp-2)]  (last species dropped)
//  P_out[n], t_out[n]
// fwd_map is the last-species pivot permutation (new index -> original),
// matching pyjac_tpu.core.mech.Mechanism.fwd_spec_mapping.
int stateio_build_states(const double* raw, int64_t n, int64_t nsp,
                         const int32_t* fwd_map, double* y_out,
                         double* P_out, double* t_out) {
  int64_t w = 3 + nsp;
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const double* row = raw + i * w;
      t_out[i] = row[0];
      P_out[i] = row[2];
      double* y = y_out + i * nsp;
      y[0] = row[1];
      for (int64_t k = 0; k + 1 < nsp; ++k) {
        y[1 + k] = row[3 + fwd_map[k]];
      }
    }
  });
  return 0;
}

// AoS (n, w) -> SoA (w, n) transpose, blocked and multi-threaded over
// rows (the reference GPU loader stores y[i + j*NUM],
// read_initial_conditions.cu:42).
int stateio_transpose(const double* aos, int64_t n, int64_t w,
                      double* soa) {
  constexpr int64_t kBlock = 64;
  parallel_for((n + kBlock - 1) / kBlock, [=](int64_t blo, int64_t bhi) {
    for (int64_t b = blo; b < bhi; ++b) {
      int64_t lo = b * kBlock;
      int64_t hi = lo + kBlock < n ? lo + kBlock : n;
      for (int64_t j = 0; j < w; ++j) {
        for (int64_t i = lo; i < hi; ++i) {
          soa[j * n + i] = aos[i * w + j];
        }
      }
    }
  });
  return 0;
}

// Mixture density rho = P * W_bar / (RU T) from full mass fractions
// (the CONV precompute, reference read_initial_conditions.c:43-54).
int stateio_density(const double* T, const double* P, const double* Yfull,
                    const double* mw, int64_t n, int64_t nsp,
                    double* rho) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const double* Y = Yfull + i * nsp;
      double inv_wbar = 0.0;
      for (int64_t k = 0; k < nsp; ++k) inv_wbar += Y[k] / mw[k];
      rho[i] = P[i] / (RU * T[i] * inv_wbar);
    }
  });
  return 0;
}

// Write rows back out (the data.bin packer, the analog of
// performance_tester.py:316-338 done natively).
int64_t stateio_save(const char* path, const double* rows, int64_t n,
                     int64_t row_width) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t wrote = std::fwrite(rows, sizeof(double),
                             static_cast<size_t>(n) * row_width, f);
  std::fclose(f);
  return static_cast<int64_t>(wrote / row_width);
}

}  // extern "C"
