// Reaction parts of the large-mechanism pipeline (K5), float64, sm_90a.
//
// Replaces the TPU kernel pyjac_tpu/ops/pallas_dd.py
// `_kernel_dd_parts_tiled` (launched from `PallasDDJacobianBig`'s
// parts_stage): `_compute_reaction_parts` + `_pdep_falloff_vals` on a
// range of reaction rows, from the (5 + 3N, B) state/thermo pre-stage
// rows [T, ln T, P, rho, mw_avg, conc, smh, dsmh].  It writes the role
// array roles (Sf + Sp + 6, R, B):
//   [vals_f_s; vals_p_s; q; dq_dT; c_u; c_1; psi_q; xi_q].
// Every reaction category: Arrhenius (negative A included), PLOG,
// Chebyshev, reversible via Kc, third-body, Lindemann / Troe / SRI
// falloff, chemically activated, species-specific pdep, fractional
// stoichiometry; CONP and CONV.  Its plain PyTorch version is
// `parts_reference` in pyjac_tpu_torch/ops/jacobian_big.py, whose
// operations (ops/jacobian.reaction_parts_at) each line of its body,
// `reaction_parts` in csrc/kinetics.cuh (shared with K4), follows in the
// same order, so that kernel and plain version round alike.
//
// What bounds it on this card: bytes.  A (reaction, state) pair writes
// Sf + Sp + 6 doubles (80 B for the 654-species class) and reads a few
// concentration / smh rows that the blocks of one state tile share
// through L2, against a few hundred f64 operations (5-10 exp/log).
//
// What the design does about it: one thread per (reaction, state),
// states fastest, so every load and store of a warp covers 32 consecutive
// doubles and every table read is one address for the whole block (a
// broadcast).  The reaction is the fastest block index, so the blocks
// that share one state tile run together and find its rows in L2.  Under
// `split_presmod` the pressure-modified reactions come first; the rows
// after them run the HAS_PM = false instantiation, which drops that
// machinery.  A mechanism with 2 reactant and 2 product slots (every one
// the port ships) runs the instantiation with those counts fixed at
// compile time, so the slot arrays stay in registers, not in local memory
// (which lives in L1); other slot counts run the run-time loops, and a
// side of more than 8 slots or a Chebyshev order above 16 the wide path,
// which keeps no per-thread array (csrc/kinetics.cuh).

#include "kinetics.cuh"

#include <cstring>

#define N_TABLES N_PARTS_TABLES
#define N_DIMS 9

// SL = 2: every reaction has 2 reactant and 2 product slots (else 0: the
// counts of d; WIDE_SLOTS: the wide path, csrc/kinetics.cuh)
template <bool HAS_PM, int SL>
__global__ void __launch_bounds__(128)
big_parts_kernel(PartsTables<double> t, PartsDims<double> d,
                 const double* __restrict__ st,
                 long long B, double* __restrict__ roles) {
  const long long b = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= B || blockIdx.x >= (unsigned)d.rows) return;
  const int r = d.row0 + blockIdx.x;
  store_roles(reaction_parts<double, HAS_PM, SL, SL>(t, d, st, B, b, r, roles,
                                                     B, b),
              roles, (size_t)(d.Sf + d.Sp) * d.R + r, d.R, B, b);
}

extern "C" int pyjac_big_parts_n_tables(void) { return N_TABLES; }

// tables: N_TABLES device pointers in PartsTables order; dims: N_DIMS ints
// {N, R, Sf, Sp, Pm, NT, NP, conp, has_frac}; rows [row0, row0 + rows) of
// roles (Sf + Sp + 6, R, B) are written, with the pressure-modification
// machinery when has_pm.  Returns the launch's cudaError_t (0 on
// success), or -1 on a table / dimension mismatch.
extern "C" int pyjac_big_parts(const void* const* tables, int n_tables,
                               const int* dims, int n_dims, double ln_pa_ru,
                               const double* st, long long B, int row0,
                               int rows, int has_pm, double* roles,
                               void* stream) {
  if (n_tables != N_TABLES || n_dims != N_DIMS) return -1;
  if (rows <= 0 || row0 < 0 || row0 + rows > dims[1]) return -1;
  const int threads = 128;
  const long long tiles = (B + threads - 1) / threads;
  if (tiles > 65535) return -1;
  PartsTables<double> t;
  std::memcpy(&t, tables, sizeof(t));
  PartsDims<double> d;
  d.N = dims[0]; d.R = dims[1]; d.Sf = dims[2]; d.Sp = dims[3];
  d.Pm = dims[4]; d.NT = dims[5]; d.NP = dims[6]; d.conp = dims[7];
  d.has_frac = dims[8]; d.row0 = row0; d.rows = rows;
  d.ln_pa_ru = ln_pa_ru;
  dim3 grid((unsigned)rows, (unsigned)tiles);
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = wide_tables(d.Sf, d.Sp, d.NT, d.NP);
  const bool two = d.Sf == 2 && d.Sp == 2;
#define BP_LAUNCH(PM, SL) \
  big_parts_kernel<PM, SL><<<grid, threads, 0, s>>>(t, d, st, B, roles)
  if (has_pm) {
    if (wide) BP_LAUNCH(true, WIDE_SLOTS);
    else if (two) BP_LAUNCH(true, 2);
    else BP_LAUNCH(true, 0);
  } else {
    if (wide) BP_LAUNCH(false, WIDE_SLOTS);
    else if (two) BP_LAUNCH(false, 2);
    else BP_LAUNCH(false, 0);
  }
#undef BP_LAUNCH
  return (int)cudaGetLastError();
}
