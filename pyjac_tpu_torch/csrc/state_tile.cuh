// A tile of states on one block, sm_90a: the per-state phases of
// csrc/kinetics.cuh run on TS consecutive states whose rows a block keeps
// on the SM.  The stage-A kernel K1 (csrc/sparse_stage_a.cu) and the dense
// fused kernels K4 / K3 (csrc/dense_fused.cu) run the phases here, then
// their own last phase: K1 stores its post rows, K4 / K3 compute the
// Jacobian's columns.  The dy/dt kernel (csrc/dydt.cu) runs them with
// F_ONLY: the same phases cut down to dy/dt, on a tile of its own
// (dydt_tile_layout).
//
// The tile is batch-minor with stride TS (row r of state s at r * TS + s),
// so the phases of kinetics.cuh run on it unchanged, called with (B, b) =
// (TS, s): no body is copied.  A block of TILE_THREADS threads keeps it in
// dynamic shared memory (the `shared` placement) or, where one state's
// rows exceed shared memory, in its slice of a global scratch (`global`:
// persistent blocks, so the live slices stay in L2).  Thread tid works on
// state s = tid % TS with the W - 1 others of its state (group g = tid /
// TS; threads past W TS sit out, as do the dead states of a ragged last
// tile).  Every sum keeps a fixed order per state, so a state's result
// does not depend on its tile.  The host's planner (ops/kernels.py
// `tile_plan`) picks TS and the placement; each C entry checks the plan's
// rows against its own layout.

#pragma once

#include "kinetics.cuh"

#define SMEM_MAX 232448      // dynamic shared memory a block may use, bytes
#define TILE_THREADS 512     // a tile's block

// A tile's rows, each TS states wide: the staged y and P (N + 1), the
// state scalars (rho, mw_avg, yN, dlnrho_dT), the state/thermo rows (5 +
// 3N; after phase 2, omega, domega and the closure's sums sh, dsh), the
// role rows ((kr + 5 + has_spec) R: kr slot roles, then q, dq_dT, c_u,
// c_1, psi_q and, only with species-specific pdep, xi_q), the post rows
// (4N + 2J + 3), then h and dcp (N each).  K4 keeps its kr = Sf + Sp slot
// roles here and adds a staging region (stage, G: csrc/dense_fused.cu);
// K1 writes its slot roles straight to its source stack (kr = 0) and
// stages 3N rows of closure terms (stage: csrc/sparse_stage_a.cu).
struct TileLayout {
  int y, scal, st, roles, post, hrow, rows, stage, G;
};

__host__ __device__ inline TileLayout state_tile_layout(int N, int R, int kr,
                                                        int has_spec) {
  const int J = N - 1;
  TileLayout L;
  L.y = 0;
  L.scal = N + 1;
  L.st = L.scal + 4;
  L.roles = L.st + 5 + 3 * N;
  L.post = L.roles + (kr + 5 + (has_spec ? 1 : 0)) * R;
  L.hrow = L.post + 4 * N + 2 * J + 3;
  L.rows = L.hrow + 2 * N;
  L.stage = L.rows;
  L.G = 0;
  return L;
}

// The dy/dt kernel's tile: y and P (N + 1), the state scalars (4), the
// state/thermo rows (5 + 3N; after phase 2, omega, dT/dt's per-species
// terms and the closure's sums), q (R), then cp, h and dcp (N each).  Of
// the post rows it keeps cp alone, which phase 1 writes at post + 3N: so
// `post` lies 3N rows before cp, over rows it never writes as post
// rows.  ops/kernels.py `dydt_tile_rows` counts the same.
__host__ __device__ inline TileLayout dydt_tile_layout(int N, int R) {
  TileLayout L;
  L.y = 0;
  L.scal = N + 1;
  L.st = L.scal + 4;
  L.roles = L.st + 5 + 3 * N;
  L.post = L.roles + R - 3 * N;
  L.hrow = L.roles + R + N;
  L.rows = L.hrow + 2 * N;
  L.stage = L.rows;
  L.G = 0;
  return L;
}

// the dy/dt kernel's strides (row, state) of its states y (N, B) and of
// its f (N, B), each of any strides; unused by K1, K4 and K3, whose y and
// f are batch-minor
struct StateStrides {
  long long yr, yb, fr, fb;
};

// Where phase 2 writes what K1 emits per reaction: the slot roles, psi_q
// times each third-body efficiency slot and xi_q (or 0) into the source
// stack src (n_src, B) at state b0 + s (SRC = true); K4 / K3 keep the slot
// roles on the tile (SRC = false, src unused).
template <typename S>
struct SourceOut {
  S* src;
  const S* eff_val;
  int S_eff;
};

// Phases 0-4 of the tile of states [b0, b0 + TS) (those below B live) in
// the rows at `tile`: (0) the tile's y and P rows; (1) state and thermo
// over species; (2) reaction_parts over reactions taken in rxn_order
// (grouped by category, so the TS threads of a warp that share a reaction
// take one path), SL = 2 fixing the 2 + 2 slot counts at compile time (0:
// the counts of d; WIDE_SLOTS: the wide path of csrc/kinetics.cuh); (3)
// the contractions over species, a spare thread group taking the
// closure's sums meanwhile; (4) the closure: the sums
// per state, then at once the temperature row's sums per state and each
// species' rows, so no group runs it alone (K1, SRC: each species'
// temperature-row terms and rows at once, then the sums of the terms in
// order, so the N-long chain of divisions is no group's alone).  col0
// / fout (N rows at stride B) take the temperature column and dy/dt.
// Stops after phase LAST, at a __syncthreads().
//
// F_ONLY (the dy/dt kernel, on dydt_tile_layout's tile): y and fout of
// the strides io; phases 0-1 as they are; phase 2 each reaction's q alone
// (reaction_parts<Q_ONLY>) into the q row; phase 3 omega alone; phase 4
// dy/dt alone: each species' dY/dt row and its term of dT/dt at once (the
// terms over the dead domega rows), then the terms summed in order per
// state, as closure_temperature sums them, so f is K4's bit for bit.
template <typename S, bool HAS_PM, int SL, bool SRC, int LAST,
          bool F_ONLY = false>
__device__ __forceinline__ void state_tile(
    const PartsTables<S>& p, const FinishTables<S>& f,
    const int* __restrict__ rxn_order, const PartsDims<S>& d, int has_spec,
    int TS, const TileLayout& L, long long b0, const S* __restrict__ y,
    const S* __restrict__ Pin, long long B, S* __restrict__ col0,
    S* __restrict__ fout, S* __restrict__ tile, const SourceOut<S>& so,
    const StateStrides& io = StateStrides{}) {
  static_assert(!(SRC && F_ONLY), "K1's sources hold no dy/dt-only body");
  const int N = d.N, R = d.R, J = N - 1, conp = d.conp;
  const int k = d.Sf + d.Sp, kr = SRC ? 0 : k;
  const int tid = threadIdx.x;
  const int live = (int)(B - b0 < TS ? B - b0 : TS);
  const int W = TILE_THREADS / TS, s = tid % TS, g = tid / TS;
  const bool on = g < W && s < live;
  const long long ts = TS, bs = b0 + s;
  S* ty = tile + (size_t)L.y * TS;
  S* scal = tile + (size_t)L.scal * TS;
  S* st = tile + (size_t)L.st * TS;
  S* omega = st;                        // phase 3 on: st's rows are free
  S* domega = st + (size_t)N * TS;
  S* sums = st + (size_t)2 * N * TS;
  S* roles = tile + (size_t)L.roles * TS;
  S* post = tile + (size_t)L.post * TS;
  S* hrow = tile + (size_t)L.hrow * TS;
  S* dcpr = hrow + (size_t)N * TS;
  auto scalars = [&]() {
    StateScalars<S> sc;
    sc.rho = scal[s];
    sc.mw_avg = scal[TS + s];
    sc.yN = scal[2 * TS + s];
    sc.dlnrho_dT = scal[3 * TS + s];
    return sc;
  };
  auto closure_sums_here = [&]() {
    const ClosureSums<S> c = closure_sums(N, ty, scalars(),
                                          post + (size_t)3 * N * TS, dcpr, ts,
                                          (long long)s);
    sums[s] = c.sh;
    sums[TS + s] = c.dsh;
  };

  // --- 0. the tile's y and P rows ------------------------------------------
  if constexpr (F_ONLY) {
    // y of any strides, read in the order of its addresses where a
    // state's rows are adjacent (the integrator's (B, N) states)
    const bool by_state = io.yr == 1;
    for (int i = tid; i < N * TS; i += TILE_THREADS) {
      const int r = by_state ? i % N : i / TS;
      const int si = by_state ? i / N : i % TS;
      if (si < live)
        ty[(size_t)r * TS + si] = y[r * io.yr + (b0 + si) * io.yb];
    }
    for (int si = tid; si < live; si += TILE_THREADS)
      ty[(size_t)N * TS + si] = Pin[b0 + si];
  } else {
    for (int i = tid; i < (N + 1) * TS; i += TILE_THREADS) {
      const int r = i / TS, si = i % TS;
      if (si < live)
        ty[(size_t)r * TS + si] =
            r < N ? y[(size_t)r * B + b0 + si] : Pin[b0 + si];
    }
  }
  __syncthreads();

  // --- 1. state and NASA-7 thermo (jacobian_big.state_thermo) -------------
  if (on) {
    const StateScalars<S> sc =
        state_phase(p, f, N, conp, ty, ty + (size_t)N * TS, ts, (long long)s,
                    g, W, st, post + (size_t)3 * N * TS, hrow, dcpr);
    if (g == 0) {
      scal[s] = sc.rho;
      scal[TS + s] = sc.mw_avg;
      scal[2 * TS + s] = sc.yN;
      scal[3 * TS + s] = sc.dlnrho_dT;
    }
  }
  __syncthreads();
  if (LAST < 2) return;

  // --- 2. reaction parts into the role rows, in rxn_order -------------------
  if (on) {
    for (int i = g; i < R; i += W) {
      const int r = rxn_order[i];
      if constexpr (F_ONLY) {
        roles[(size_t)r * TS + s] =
            reaction_parts<S, HAS_PM, SL, SL, true>(p, d, st, ts, s, r,
                                                    nullptr, ts, s).q;
      } else if (SRC) {
        const ReactionRoles<S> v = reaction_parts<S, HAS_PM, SL, SL>(
            p, d, st, ts, s, r, so.src, B, bs);
        store_roles(v, roles, r, R, ts, s, has_spec != 0);
        S* src = so.src + bs;
        for (int e = 0; e < so.S_eff; ++e)
          src[((size_t)(k + e) * R + r) * B] =
              v.psi_q * so.eff_val[(size_t)r * so.S_eff + e];
        src[((size_t)(k + so.S_eff) * R + r) * B] =
            has_spec ? v.xi_q : S(0);
      } else {
        store_roles(reaction_parts<S, HAS_PM, SL, SL>(p, d, st, ts, s, r,
                                                      roles, ts, s),
                    roles, (size_t)k * R + r, R, ts, s, has_spec != 0);
      }
    }
    if (SRC && g == 0)                                      // the zero row
      so.src[(size_t)(k + so.S_eff + 1) * R * B + bs] = S(0);
  }
  __syncthreads();
  if (LAST < 3) return;

  // --- 3. stoichiometric contractions nu_net^T [q, dq_dT, c_u, cv] -----------
  // (with a thread group to spare, its last one takes the closure's sums)
  const bool spare = W > N;
  if (on) {
    if constexpr (F_ONLY)
      contract_phase<S, HAS_PM, true>(f, has_spec, N, R, roles, ts, s, g, W,
                                      omega, domega, post, post);
    else
      contract_phase<S, HAS_PM>(f, has_spec, N, R, roles + (size_t)kr * R * TS,
                                ts, s, g, W, omega, domega, post,
                                post + (size_t)N * TS);
    if (spare && g == W - 1) closure_sums_here();
  }
  __syncthreads();
  if (LAST < 4) return;

  // --- 4. closure: dy/dt, the temperature column, the post rows ---------------
  if (!spare) {
    if (on && g == 0) closure_sums_here();
    __syncthreads();
  }
  if constexpr (F_ONLY) {
    // dy/dt: each species' dY/dt row and its term of dT/dt at once (the
    // terms over the dead domega rows), then the terms' sum in order
    S* terms = domega;
    const StateScalars<S> sc = scalars();
    if (on) {
      const S denomT = sc.rho * sums[s];
      for (int n = g; n < N; n += W) {
        terms[(size_t)n * TS + s] =
            temperature_term_f(f, n, denomT, hrow, omega, ts, (long long)s);
        if (n < J)
          closure_species<S, true>(f, N, n, sc, omega, domega, ts,
                                   (long long)s, post, col0, fout, io.fr,
                                   bs * io.fb);
      }
    }
    __syncthreads();
    if (on && g == 0) {
      S fT = S(0);
      for (int n = 0; n < N; ++n) fT -= terms[(size_t)n * TS + s];
      fout[bs * io.fb] = fT;
    }
  } else if (SRC) {
    // K1: every species' temperature-row terms at once, into the dead
    // role rows (stage), then their sums in order on one thread group
    S* terms = tile + (size_t)L.stage * TS;
    const StateScalars<S> sc = scalars();
    const ClosureSums<S> c = {sums[s], sums[TS + s]};
    if (on)
      for (int n = g; n < N; n += W) {
        const TemperatureTerms<S> tt =
            temperature_terms(f, N, n, sc.rho * c.sh, hrow, omega, domega,
                              ts, (long long)s, post);
        terms[(size_t)n * TS + s] = tt.fT;
        terms[(size_t)(N + n) * TS + s] = tt.s1;
        terms[(size_t)(2 * N + n) * TS + s] = tt.s2;
        if (n < J)
          closure_species(f, N, n, sc, omega, domega, ts, (long long)s, post,
                          col0, fout, B, bs);
      }
    __syncthreads();
    if (on && g == 0) {
      S fT = S(0), s1 = S(0), s2 = S(0);
      for (int n = 0; n < N; ++n) {
        fT -= terms[(size_t)n * TS + s];
        s1 += terms[(size_t)(N + n) * TS + s];
        s2 += terms[(size_t)(2 * N + n) * TS + s];
      }
      temperature_row(N, sc, c, fT, s1, s2, ts, (long long)s, post, col0,
                      fout, bs);
    }
  } else if (on) {
    const StateScalars<S> sc = scalars();
    if (g == 0) {
      const ClosureSums<S> c = {sums[s], sums[TS + s]};
      closure_temperature(f, N, sc, c, hrow, omega, domega, ts, (long long)s,
                          post, col0, fout, B, bs);
    }
    for (int n = g; n < J; n += W)
      closure_species(f, N, n, sc, omega, domega, ts, (long long)s, post,
                      col0, fout, B, bs);
  }
  __syncthreads();
}
