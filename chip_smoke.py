"""On-card smoke run of the PyTorch + CUDA port (``pyjac_tpu_torch``).

Drives the port's paths — the flagship 53-species / 325-reaction
mechanism's analytical Jacobian + dy/dt through ``SparseJacobian``
(kernels K1, K2; K2x with ``fuse_gather=False``), the large-mechanism
pipeline ``BigJacobian`` (kernels K5, K6, K7) at the 654-species /
2716-reaction and USC-II (111 / 784) classes, the stiff integrator
``integrate(jacobian='dd')`` with the dense fused kernel K4, the float32
path ``F32Jacobian`` (kernel K3) and the port's bench
(``python -m pyjac_tpu_torch.bench``, with the 1M-state
``BatchEvaluator`` cell) and the user front end (the performance and
functional testers, the CLI, the PaSR generator) — on one CUDA card, in
phases; any failure exits non-zero at once:

1. device: a CUDA card is required; prints its ``nvidia-smi`` name and
   power limit;
2. build: compiles the six sources of ``pyjac_tpu_torch/csrc`` with
   nvcc (one process each, all at once) and loads them, then counts the
   float64 SASS instructions of K3 (the float instantiation of
   ``dense_fused_kernel``) with ``cuobjdump``, which runs in the
   background and is read after phase 5 (2b): there must be none;
3. kernels vs plain: K1 and K2 against their plain PyTorch versions on
   the same inputs, CONP and CONV: 16384 flagship states, and 16384
   states of the all-features synth at the flagship's width (53 species
   / 326 reactions: PLOG, Chebyshev, SRI, chemically activated,
   species-specific pdep, fractional nu); then the performance tester's
   ``dd-sparse`` batches (phase 15b): the flagship at B = 131072 and
   USC-II at B = 32768;
3b. K1 against ``stage_a_reference`` at phase 3's tolerances, CONP and
   CONV, on the flagship at B = 4099 (a ragged last tile) under the
   planner's tile and under the global placement, the USC-II class at
   B = 4096 (4 states a tile) and the 654 class at B = 128 (one state a
   tile) and, under the global placement, at B = 127;
4. golden: the 128 reference-C golden states of
   ``tests/data/golden_flagship_refc.npz`` and the all-features synth's
   (9/24, ``golden_synth_refc.npz``) through ``SparseJacobian``;
5. main path: the flagship states tiled to B = 131072 through
   ``SparseJacobian.call_tr`` (one warm-up, best of 3 timed passes with
   CUDA events), with both kernels' launch counters checked, then each
   stage timed alone against its plain version and (K2) one PyTorch
   library call at the same B;
5b. the all-features path: the 53/326 synth's ``random_states(seed=3)``
   at B = 131072 through ``SparseJacobian.call_tr``, fused (K1 + K2) and
   unfused (K1, the gather, K2x), each timed as phase 5 with its launch
   counters, peak memory and (fused) a ``torch.profiler`` split; K1
   against ``stage_a_reference`` and K2 and K2x on K1's outputs against
   ``stage_b_reference``, all at that B and phase 3's tolerances; K1
   alone beside its plain version and its bound; J against
   ``DenseJacobian`` (K4) on 4096 of the states; K1 alone at the USC-II
   class (B = 32768) beside its plain version and its bound;
6. big kernels vs plain: K5, K6 and K7 against their plain versions on
   the same inputs, CONP and CONV, at the shape of each timed path of
   phase 8 (K5 + K6 at the 654 class, B = 1024, and at the USC-II class,
   B = 32768; K5 + K7 at the 654 class, B = 512) and on the 9/24
   all-features synth (PLOG, Chebyshev, SRI, chemically activated,
   fractional nu; B = 16384);
7. big golden: both reference-C goldens through ``BigJacobian`` (the
   default K5 + K6 configuration and the dense K7 one);
8. big paths at full width, each timed (one warm-up, best of 3 CUDA
   event passes, a ``torch.sum`` of every output inside the pass) with
   its launch counters set to 0 just before and read just after: the
   654-class default configuration at B = 1024 and the USC-II class at
   B = 32768 (each checked against ``SparseJacobian``), and the dense K7
   configuration at the 654 class, B = 512; then the stage split and
   each kernel alone beside its plain version, its bound and one
   PyTorch library call, and K7 alone at B = 1024 beside K6 there;
9. K4 and K2x vs plain: K4 against ``dense_reference`` on the flagship
   at B = 32768 (the integrate cell's shape), the 9/24 synth at
   B = 16384, the flagship at B = 4099 (a ragged last tile) under the
   planner's tile and under the global placement, the USC-II class at
   B = 4096 (3 states a tile, ragged) and the 654 class at B = 128 (its
   rows exceed shared memory: global slices), and the performance
   tester's ``dd`` batches (the flagship at B = 131072, USC-II at
   B = 32768), CONP and CONV; K2x against
   ``stage_b_reference`` on the gathered operand at B = 131072;
10. dense golden: both goldens through ``DenseJacobian`` and the
    flagship's through ``SparseJacobian(fuse_gather=False)``;
11. the integrate path: the flagship PaSR states tiled to B = 32768
    through ``integrate(..., 1e-4, jacobian='dd', method='ros23')`` (one
    warm-up, best of 3 with CUDA events; every state must succeed, and
    K4 launch once per loop iteration), its ``torch.profiler`` split per
    iteration, K4 alone beside its plain version and bound; then
    ``jacobian='dd'`` against ``'xla'`` (equal steps, endpoints) for
    ROS23 and RODAS3 on 4096 states and for 256 states heated by
    300 K; then the ``fuse_gather=False`` flagship path at B = 131072
    timed as phase 5, and K2x alone;
12. K3 vs plain: ``F32Jacobian`` (K3, float32) against ``f32_reference``
    on the same states, CONP and CONV, at the flagship's f32 cell
    (``random_states(seed=1, T_range=(1500, 2500))``, B = 262144), on
    the 9/24 synth at B = 16384, the flagship at B = 4099 (ragged), the
    USC-II class at B = 4096 (6 states a tile, ragged) and the 654 class
    at B = 128 (one state a tile) and, under the global placement, at
    B = 127 (ragged), with the JAX package's f32 metric (finite
    share >= 0.995, max |diff| on the entries finite on both sides
    < 2e-5 of scale, J and f) and phase 9a's gates on each state's own
    scales, which must catch a fault planted in K3's output; K3 against
    the float64 ``SparseJacobian`` on 65536 of those flagship states; the
    flagship golden through ``F32Jacobian`` (J gated, dy/dt printed);
13. the f32 cell: B = 262144 through ``F32Jacobian.call_tr``, timed as
    phase 5 with its launch counter, its ``torch.profiler`` split (a
    trace short of K3's records is retaken, then not measured), and K3
    alone beside its plain version and its bound;
14. the port's bench (``pyjac_tpu_torch.bench.run``: the headline, the
    1M-state device-resident cell, the f32 cell), its one-line JSON and
    the 1M cell's staging split.
15. the user front end, in a work directory under the build directory
    (the flagship's Chemkin text and its 4032 PaSR states, the USC-II
    class with ``random_states(seed=3)``): the performance tester
    (``testers.performance.performance_tester``) sweeps ``dd-sparse``
    (K1 + K2), ``dd`` (K4) and ``pallas`` (K3) up to B = 131072
    (``pallas`` 262144) and ``ajac`` / ``ad`` / ``fd`` (plain torch) at
    the flagship, then ``dd-sparse`` and ``dd`` at the USC-II class, each
    call with the launch counters set to 0 just before and read just
    after (each method launches its kernels and no other); every output
    file holds its repeats per size, a second call appends nothing, and
    the ``dd-sparse`` / ``pallas`` / ``dd`` readings are printed beside
    phases 5 / 13 / 11's (phases 3, 9a and 12 hold K1 + K2, K4 and K3
    against their plain versions at each method's largest batch at each
    mechanism); the functional tester
    (``python -m pyjac_tpu_torch.testers``) on 64 of the flagship's PaSR
    states, gated at twice the JAX package's reading; the CLI
    (``python -m pyjac_tpu_torch``) with ``--validate`` CONP and CONV and
    ``-ic``; a short PaSR run through the port's integrator.

Phases 12-13 run between 10 and 11: a ``torch.profiler`` session after
phase 11's traced integrate call records no kernels on the card.

The last three lines of standard output are one JSON object with a
row per kernel, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``.  Without a
CUDA card it exits non-zero and prints no result.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from pyjac_tpu_torch import bench, cli  # noqa: E402
from pyjac_tpu_torch.core.constants import RU  # noqa: E402
from pyjac_tpu_torch.integrate import STATUS_SUCCESS, integrate  # noqa: E402
from pyjac_tpu_torch.ops.jacobian import reaction_parts  # noqa: E402
from pyjac_tpu_torch.ops import kernels  # noqa: E402
from pyjac_tpu_torch.ops.jacobian_big import (  # noqa: E402
    ROLE_NAMES, BigJacobian, cols_dense_reference, cols_sparse_reference,
    dense_col_tables, finish, p1_dense, parts_reference, source_stack,
    state_thermo)
from pyjac_tpu_torch.ops.jacobian_dense import (  # noqa: E402
    DenseJacobian, dense_reference)
from pyjac_tpu_torch.ops.jacobian_f32 import (  # noqa: E402
    F32Jacobian, f32_reference)
from pyjac_tpu_torch.ops.jacobian_sparse import (  # noqa: E402
    SparseJacobian, finish_coefs, post_rows, stage_a_reference,
    stage_b_reference)
from pyjac_tpu_torch.testers import pasr  # noqa: E402
from pyjac_tpu_torch.testers.__main__ import main as testers_main  # noqa: E402
from pyjac_tpu_torch.testers.performance import (  # noqa: E402
    PerfConfig, check_step_file, method_precision, performance_tester)
from pyjac_tpu_torch.testers.synthetic import (  # noqa: E402
    flagship, packed_from_text, plausible_mechanism, random_states,
    synthetic_mechanism)

F64 = torch.float64
DATA = os.path.join(HERE, 'tests', 'data')

# tolerances (kernel vs plain version on the card: the kernels sum in
# another order than torch's reductions and matmuls, so not bit-exact)
TOL_ELEMENTWISE = 1e-12   # rows without a stoichiometric or net-rate sum,
#                           per-row norm-relative
TOL_NET = 1e-8            # arrays that sum net rates, norm-relative per
#                           state (the repo's dy/dt metric): PaSR states sit
#                           near equilibrium, where net rates cancel to ~1e-9
#                           of the gross fluxes and magnify roundoff
# bounds set from readings on an H100 (NVIDIA H100 80GB HBM3, 700 W) at
# 16384 flagship states, CONP and CONV:
TOL_PSI_Q = 1e-9          # third-body source rows psi*(Rf - Rr)*eff carry a
#                           net rate; per row, read 1.8e-10
TOL_F_GROSS = 1e-12       # dy/dt species rows (K1, K4), each entry on the
#                           summed magnitude of the terms omega = nu^T q
#                           adds, sum_r |nu_rn| |pm_r| (|Rf_r| + |Rr_r|)
#                           W_n / rho: near equilibrium a row cancels up to
#                           ~1e7-fold, so on its own scale two summation
#                           orders differ by up to 2.4e-8 (the plain version
#                           against the JAX package's f64 dydt reads 5.7e-15
#                           of the terms, tests/test_torch_sparse.py)
TOL_J = 1e-9             # Jacobian columns, floored at 1e-10 of the state
# golden parity (tests/test_golden_parity.py:255-274)
TOL_GOLDEN_J = 1e-8
TOL_GOLDEN_F = 1e-7
# ... and the all-features golden's (TestAllFeaturesGolden): J floored at
# 1e-9 < TOL_GOLDEN_J, dy/dt floored at 1e-9 < this
TOL_SYNTH_GOLDEN_F = 1e-10
# the large-mechanism pipeline: K5 role rows without a net rate
# (vals_f/vals_p, c_u, c_1) are elementwise (TOL_ELEMENTWISE, per row);
# rows that carry a net rate of progress (q, dq_dT, psi_q, xi_q) cancel
# and are held per row at
TOL_ROLE_NET = 1e-9
TOL_BIG_J = 1e-9          # K6/K7 (also K4, K2, K2x) vs plain, J species
#                           rows floored at 1e-10 of the state (its whole J)
TOL_BIG_JT = 1e-12        # ... and J's temperature row, relative to the
#                           summed magnitude of the N + 1 terms it adds: the
#                           terms exceed the row up to 3.2e6-fold at USC-II
#                           states, so on the floored scale two f64
#                           summation orders differ by up to 2.2e-8 there
#                           (K2 on the 53/326 synth at B = 131072: 1.3e-9)
TOL_CROSS = 1e-8          # BigJacobian vs SparseJacobian (K1/K2), floored;
#                           also K4's J species rows against its plain
#                           version at the USC-II and 654 classes (phase
#                           9a), whose rows cancel further: K4 reads
#                           1.33e-9 floored at USC-II CONP on 4096 states,
#                           the pre-tile kernel the same (same arithmetic)
BIG_CLASSES = ('usc', '654')
TOL_INTEGRATE = 1e-9      # integrate jacobian='dd' vs 'xla': endpoints
#                           floored at 1e-10 of each state's largest entry
# K3 (float32), the JAX package's f32 metric (tests/test_pallas_jacobian.py:
# 52-59): entries finite on both sides, max |diff| / scale, and the share
# of finite entries
TOL_F32 = 2e-5
F32_FINITE = 0.995
# ... and beside it, for K3 against its plain version, phase 9a's gates
# (K4's) on each state's own scales over those entries: that metric's one
# scale is the largest |J| entry of the batch, a temperature-row entry of
# the hottest state, and the median species entry is ~4e-12 of it.
# Set from readings on an H100 (NVIDIA H100 80GB HBM3, 700 W) at the
# flagship's f32 cell and the 9/24 synth, CONP and CONV:
TOL_F32_NET = 1e-4        # col0 and f: T rows per row, Y rows per state and
#                           per row; read up to 1.0e-5
F32_FLOOR = 1e-3          # J species rows floored at this x the state's
TOL_F32_JY = 1e-3         # largest species-row entry; read up to 2.0e-4
TOL_F32_JT = 1e-4         # J's temperature row on the summed magnitude of
#                           its terms; read up to 1.1e-5
F32_FAULT = 1e-2          # the planted fault: J's species rows, or its
#                           temperature row, scaled by 1 + this
TOL_F32_GOLDEN_F = 0.14   # K3's golden dy/dt, max |diff| / scale (PaSR
#                           states near equilibrium, where float32 loses
#                           most digits): twice the JAX package's own f32
#                           kernel's reading, 7.0e-2 (PallasJacobian,
#                           interpret, CPU; tests/test_torch_f32.py)

# the integrate cell's horizon: one CFD flow step's chemistry sub-step
T_END = 1e-4

# phase 5b's cross-check of SparseJacobian against DenseJacobian (K4)
SYNTH_CROSS_B = 4096

# BigJacobian's default configuration is K5 + K6 (split_presmod on);
# the dense one runs K5 + K7
BIG_DENSE = dict(sparse_cols=False)

# phase 15: the performance tester's sweep, (method, steps) per call, at
# the flagship (the kernel methods up to the main path's B, 'pallas' to
# the f32 cell's), then at the USC-II class; repeats per size
FRONT_RUNS = (('dd-sparse', [4096, 32768, 131072]),
              ('dd', [4096, 32768, 131072]),
              ('pallas', [4096, 32768, 131072, 262144]),
              ('ajac', [4096, 32768]), ('ad', [4096]), ('fd', [4096]))
USC_RUNS = (('dd-sparse', [4096, 32768]), ('dd', [4096, 32768]))
FRONT_REPEATS = 2
# the JAX package's functional tester (run_functional_test, CPU, f64) on
# the 64 flagship PaSR states `-n 64` selects, the worst state of each
# metric (tests/test_torch_testers.py prints and pins them), printed beside
# the card's
FUNCTIONAL_JAX_CPU = {'err_jac_thr_max': 4.0016e-7, 'err_dydt': 1.8779e-2,
                      'err_jac_norm': 1.8965e-15, 'err_jac_fd': 2.4730e-13}
# the functional tester's gate: the worst thresholded max-relative error
# of the closed-form J against forward-mode AD (entries above ||J|| /
# 1e20), twice the JAX package's reading (the port's on the CPU: 6.814e-7).
# The worst entry is a cancelled one just above the threshold: 9.4e-5 in a
# row whose largest entry is 9.5e9
TOL_FUNCTIONAL = 2 * FUNCTIONAL_JAX_CPU['err_jac_thr_max']
# phase 15e's PaSR: a time-integrable plausible mechanism, particles x
# species > 1024 (the port's integrator, not scipy's BDF), one residence
# time of ten steps.  The pilot (1900 K) and the inlet (1000 K) are relaxed
# as in tools/make_bench_states.py, over these horizons, and the inlet
# enters at its relaxed temperature; the chemistry's (rtol, atol, max
# steps) trade accuracy for a run of seconds (on the CPU, the integrator's
# iterations: 3978 at (1e-5, 1e-9), 170 at these)
PASR_MECH = (33, 120)
PASR_PARTICLES = 32
PASR_TAU_RES = 1e-5
PASR_P_ATM = 10.0
PASR_RELAX = (1e-5, 1e-6)
PASR_TOLS = (1e-3, 1e-7, 3000)

# H100 SXM peaks (NVIDIA H100 SXM data sheet), for each kernel's bound:
# HBM3 bandwidth; FP64 outside the tensor cores (no kernel here issues
# DMMA: the 67 TFLOP/s FP64 tensor-core rate does not apply); FP32 (K3)
HBM_BYTES_S = 3.35e12
F64_FLOP_S = 34e12
F32_FLOP_S = 67e12
# operations one exp / log / log10 / pow counts for in a bound: a
# polynomial of degree ~10 after range reduction, in f64 and f32 alike
TRANSCENDENTAL_OPS = 20

# float64 SASS: D* arithmetic / compares and any F64 or 64H operand form
F64_SASS_OP = re.compile(r'^(D(ADD|MUL|FMA|SETP|MNMX|SET|RSQ)\b|\S*F64|'
                         r'\S*64H)')


class Fail(Exception):
    pass


# processes the script started, stopped when it exits
CHILDREN = []


def check(ok, msg):
    if not ok:
        raise Fail(msg)


def row_rel(a, b):
    """max over rows of max|a-b| / max|b| along the batch axis (-1)."""
    err = (a - b).abs().amax(dim=-1)
    scale = b.abs().amax(dim=-1).clamp_min(1e-300)
    return float((err / scale).max())


def state_rel(a, b):
    """max over states of max|a-b| / max|b| over the array's rows (-2);
    a one-row array normalizes over the batch instead."""
    if a.shape[0] == 1:
        return row_rel(a, b)
    err = (a - b).abs().amax(dim=0)
    scale = b.abs().amax(dim=0).clamp_min(1e-300)
    return float((err / scale).max())


def floored(a, b, floor):
    """Per-state floored relative error of (..., B) arrays: entries
    below ``floor`` x the state's largest entry compare on that scale."""
    return float(floored_err(a, b, floor).max())


def floored_err(a, b, floor):
    """The elementwise errors that :func:`floored` maximises."""
    bmax = b.abs().reshape(-1, b.shape[-1]).amax(dim=0)
    denom = torch.maximum(b.abs(), bmax * floor + 1e-300)
    return (a - b).abs() / denom


def flagship_states(B):
    d = np.load(os.path.join(DATA, 'flagship_states.npz'))
    reps = -(-B // len(d['y']))
    return np.tile(d['y'], (reps, 1))[:B], np.tile(d['P'], reps)[:B]


def to_tr(y, P, device):
    y_t = torch.as_tensor(y.T.copy(), dtype=F64, device=device)
    P_t = torch.as_tensor(np.asarray(P)[None].copy(), dtype=F64,
                          device=device)
    return y_t, P_t


def per_call_ms(fn, n=10):
    """ms per call of ``fn``: best of 3 runs of ``n`` queued calls."""
    return best_ms(lambda: [fn() for _ in range(n)]) / n


def best_ms(fn, reps=3, warm=1):
    """Best of ``reps`` timed calls of ``fn`` in ms, CUDA events, after
    ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return min(times)


def smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, 'nvidia-smi failed: %s' % out.stderr)
    return out.stdout.strip().splitlines()[0]


def f_gross(packed, y_t, param, conp):
    """(J, B): for each dy/dt species row, the summed magnitude of the
    terms omega = nu_net^T q adds, sum_r |nu_rn| |pm_r| (|Rf_r| + |Rr_r|)
    W_n / rho, from the float64 plain pieces on the states."""
    rp = reaction_parts(packed, param[0], y_t.T, conp)
    q_gross = rp['pm'].abs() * (rp['Rf'].abs() + rp['Rr'].abs())
    nu = torch.as_tensor(packed.nu_net, dtype=F64, device=y_t.device).abs()
    mw = torch.as_tensor(packed.mw, dtype=F64, device=y_t.device)
    return ((q_gross @ nu) * mw / rp['rho'][:, None]).T[:-1].contiguous()


def on_terms(diff, gross):
    """max |diff| / gross, where a row with no terms (a species no
    reaction touches: gross 0) must agree exactly (0 / 0 counts 0)."""
    d = diff.abs()
    return float(torch.where(d == 0, 0.0, d / gross).max())


def case_states(name, packed, B, device):
    """The states of a phase-3 / 9 case: the flagship's PaSR states, else
    the mechanism's ``random_states(seed=3)``."""
    if name == 'flagship':
        return to_tr(*flagship_states(B), device)
    return big_states(packed, B, device)


def tester_shapes(method):
    """[(mechanism, B)]: the performance tester's largest batch of
    ``method`` at each mechanism phase 15b sweeps (``FRONT_RUNS`` at the
    flagship, ``USC_RUNS`` at USC-II)."""
    return [(name, max(steps))
            for name, runs in (('flagship', FRONT_RUNS), ('usc', USC_RUNS))
            for m, steps in runs if m == method]


def with_tester_shapes(cases, method, mechs, extra):
    """``cases`` (tuples starting (name, packed, B)) followed by a case
    ``(name, mechs[name], B) + extra`` for each of :func:`tester_shapes`
    of ``method`` that they lack, so that the kernels the tester's sweep
    launches are held against their plain versions at its shapes."""
    have = {(c[0], c[2]) for c in cases}
    return tuple(cases) + tuple((n, mechs[n], B) + extra
                                for n, B in tester_shapes(method)
                                if (n, B) not in have)


def card_plan(mod, dtype, B, placement=None):
    """The launch plan of ``mod``'s tile kernel (K1, K4 or K3) on this card
    (``kernels.tile_plan``), with the placement forced where
    ``placement`` is given."""
    return kernels.tile_plan(
        mod, dtype, B, torch.cuda.get_device_properties(
            mod.device).multi_processor_count, placement=placement)


def plan_tag(plan):
    return '%d states a tile, %s' % (plan['tile'], plan['placement'])


def phase_kernels_vs_plain(cases, device, card):
    """Phase 3: K1 and K2 against their plain versions, same inputs, CONP
    and CONV; the case marked ``main`` gives the rows' ``max_abs_err``
    (CONP).  K2's whole J is also gated floored, except at the USC-II and
    654 classes: there J's temperature row cancels (its terms exceed it up
    to 3.2e6-fold), so on the floored scale two summation orders differ
    there most (phase 6 reads K6's 2.2e-8 at USC-II), and that row is held
    on the summed magnitude of its terms, as phases 5b and 6 hold it."""
    res = {}
    for name, packed, B, main in cases:
        y_t, P_t = case_states(name, packed, B, device)
        for conp in (True, False):
            sj = SparseJacobian(packed, conp=conp, device=device)
            param = P_t if conp else own_density(packed, y_t, P_t)
            ref = stage_a_reference(packed, y_t, param, conp)
            got = sj.stage_a(y_t, param)
            torch.cuda.synchronize()
            tag = '%s %s B=%d' % (name, 'conp' if conp else 'conv', B)
            gate_stage_a(sj, y_t, param, got, ref, tag)
            max_a = max(float((got[k] - ref[k]).abs().max())
                        for k in ('src', 'col0', 'f', 'post'))
            cref = stage_b_reference(sj.gidx, sj.nuc, sj.inv_mw, ref['src'],
                                     ref['post'], conp)
            cgot = sj.stage_b(ref['src'], ref['post'])
            gate_stage_b(sj, tag, cgot, cref, ref,
                         whole=name not in BIG_CLASSES)
            if conp and main:
                res = dict(stage_a=max_a,
                           stage_b=float((cgot - cref).abs().max()))
            del ref, got, cref, cgot, sj
            torch.cuda.empty_cache()
    print('phase 3 kernels vs plain: ok (%s)' % card)
    return res


def phase_stage_a_tiles(cases, device, card):
    """Phase 3b: K1 against ``stage_a_reference`` on the same inputs, CONP
    and CONV, at phase 3's tolerances, beyond the shapes phase 3 holds:
    each case (name, packed, B, placement) runs the planner's tile, or the
    placement given (a ragged batch under both placements, the USC-II
    class and the 654 class)."""
    for name, packed, B, placement in cases:
        y_t, P_t = case_states(name, packed, B, device)
        for conp in (True, False):
            param = P_t if conp else own_density(packed, y_t, P_t)
            sj = SparseJacobian(packed, conp=conp, device=device)
            plan = card_plan(sj, F64, B, placement)
            got = kernels.stage_a(sj, y_t, param, plan=plan)
            ref = stage_a_reference(packed, y_t, param, conp)
            torch.cuda.synchronize()
            gate_stage_a(sj, y_t, param, got, ref, '%s %s B=%d (%s)' % (
                name, 'conp' if conp else 'conv', B, plan_tag(plan)))
            del got, ref, sj
            torch.cuda.empty_cache()
    print('phase 3b K1 tiles vs plain: ok (%s)' % card)


def gate_stage_a(sj, y_t, param, got, ref, tag):
    """Hold K1's outputs ``got`` against ``stage_a_reference``'s ``ref`` on
    the same states, each row set at its own tolerance."""
    packed, conp, R = sj.packed, sj.conp, sj.R
    errs = {}
    # source stack: per-slot values are elementwise; the third-body rows
    # psi*(Rf - Rr)*eff and the species-pdep row xi*(Rf - Rr) carry a net
    # rate of progress
    n_vals = (sj.Sf + sj.Sp) * R
    errs['src_vals'] = (row_rel(got['src'][:n_vals], ref['src'][:n_vals]),
                        TOL_ELEMENTWISE)
    a = n_vals + sj.S_eff * R
    if sj.S_eff:
        errs['src_psi_q'] = (row_rel(got['src'][n_vals:a],
                                     ref['src'][n_vals:a]), TOL_PSI_Q)
    if packed.has_specific_pdep_sp:
        errs['src_xi_q'] = (row_rel(got['src'][a:a + R],
                                    ref['src'][a:a + R]), TOL_PSI_Q)
        errs['src_zero_row'] = (float(got['src'][-1].abs().max()), 0.0)
    else:
        errs['src_zero_rows'] = (float(got['src'][a:].abs().max()), 0.0)
    # the temperature row (0) of col0 and f is far larger than the species
    # rows, so each part is gated on its own scale
    for k in ('col0', 'f'):
        errs[k + ' T'] = (row_rel(got[k][:1], ref[k][:1]), TOL_NET)
        errs[k + ' Y'] = (state_rel(got[k][1:], ref[k][1:]), TOL_NET)
    gross = f_gross(packed, y_t, param, conp)
    errs['f Y on terms'] = (on_terms(got['f'][1:] - ref['f'][1:], gross),
                            TOL_F_GROSS)
    print('  %s f Y per row on its own scale %.3e' % (
        tag, row_rel(got['f'][1:], ref['f'][1:])))
    del gross
    for nm, (lo, hi) in post_rows(sj.N, sj.J).items():
        ga, ra = got['post'][lo:hi], ref['post'][lo:hi]
        errs[nm] = ((state_rel(ga, ra), TOL_NET)
                    if nm in ('v_u', 'v_c', 'fkJ', 'fT')
                    else (row_rel(ga, ra), TOL_ELEMENTWISE))
    for nm, (err, tol) in errs.items():
        print('  stage A %s %-13s %.3e (<= %.0e)' % (tag, nm, err, tol))
    for nm, (err, tol) in errs.items():
        check(err <= tol, 'stage A %s %s: %.3e > %.0e' % (tag, nm, err, tol))


def gate_stage_b(sj, tag, cgot, cref, a, what='stage B', whole=False):
    """Hold a column kernel's J (K2 or K2x) against ``stage_b_reference``'s
    on the same stage-A outputs ``a``, as phases 6 and 9a hold K6/K7 and
    K4: J's species rows floored at 1e-10 of each state's J, its
    temperature row on the summed magnitude of the terms it adds (that
    row cancels, so on the floored scale two summation orders differ
    most there); with ``whole``, also the whole J floored (phase 3)."""
    torch.cuda.synchronize()
    e = floored_err(cgot, cref, 1e-10)
    dcol = torch.einsum('jnr,jrb->jnb', sj.nuc, a['src'][sj.gidx])
    gross = t_row_gross(dcol, sj.inv_mw, a['post'], sj.conp)
    del dcol
    errs = {'J Y': (float(e[:, 1:].max()), TOL_BIG_J),
            'J T on terms': (float(((cgot[:, 0] - cref[:, 0]).abs() /
                                    gross).max()), TOL_BIG_JT)}
    if whole:
        errs['J floored'] = (float(e.max()), TOL_J)
    print('  %s %s J T floored@1e-10 %.3e' % (what, tag, float(e[:, 0].max())))
    del e, gross
    for nm, (err, tol) in errs.items():
        print('  %s %s %-12s %.3e (<= %.0e)' % (what, tag, nm, err, tol))
    for nm, (err, tol) in errs.items():
        check(err <= tol, '%s %s %s: %.3e > %.0e' % (what, tag, nm, err, tol))


def phase_golden(goldens, device, card):
    """Phase 4: the reference-C golden states through SparseJacobian: the
    flagship's at the repo's parity gates, the all-features synth's at
    ``TestAllFeaturesGolden``'s (J and dy/dt floored at 1e-9)."""
    for name, packed in goldens:
        g = np.load(os.path.join(DATA, 'golden_%s_refc.npz' % name))
        sj = SparseJacobian(packed, device=device)
        if name == 'flagship':
            errJ, errf = golden_errs(sj, g)
            what, tol_f = 'J floored@1e-10', TOL_GOLDEN_F
            fwhat = 'dy/dt norm-rel'
        else:
            errJ, errf = golden_errs(sj, g, floor=1e-9, f_floor=1e-9)
            what, tol_f = 'J floored@1e-9', TOL_SYNTH_GOLDEN_F
            fwhat = 'dy/dt floored@1e-9'
        print('phase 4 golden %s (SparseJacobian): %s %.3e (< %.0e), %s '
              '%.3e (< %.0e) (%s)' % (name, what, errJ, TOL_GOLDEN_J, fwhat,
                                      errf, tol_f, card))
        check(errJ < TOL_GOLDEN_J, 'golden %s J %.3e' % (name, errJ))
        check(errf < tol_f, 'golden %s dy/dt %.3e' % (name, errf))


def golden_errs(mod, g, floor=1e-10, f_floor=None):
    """(J floored@``floor``, dy/dt norm-relative per state, or floored at
    ``f_floor`` when given) of ``mod`` on the golden states of ``g``
    against its reference-C values, with the Jacobian in the reference's
    column-major layout."""
    J, f = mod(torch.as_tensor(g['y'], device=mod.device),
               torch.as_tensor(g['P'], device=mod.device))
    n = len(g['T'])
    Jl = J.cpu().numpy().transpose(0, 2, 1).reshape(n, -1)
    f = f.cpu().numpy()
    check(np.all(np.isfinite(Jl)) and np.all(np.isfinite(f)),
          'golden: non-finite output')
    ref = g['ref_jac']
    denom = np.maximum(np.abs(ref),
                       np.abs(ref).max(-1, keepdims=True) * floor + 1e-300)
    fr = g['ref_dydt']
    if f_floor is None:
        ef = (np.abs(f - fr).max(-1) / np.abs(fr).max(-1)).max()
    else:
        ef = (np.abs(f - fr) / np.maximum(
            np.abs(fr), np.abs(fr).max(-1, keepdims=True) * f_floor +
            1e-300)).max()
    return float((np.abs(Jl - ref) / denom).max()), float(ef)


def phase_main(sj, packed, device, B, card):
    """Phase 5: the main path at bench size, then each stage alone."""
    y, P = flagship_states(B)
    y_t, P_t = to_tr(y, P, device)
    sums = {}

    def one_pass():
        out = sj.call_tr(y_t, P_t)
        sums['chk'] = [torch.sum(x) for x in out]

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    total_ms = best_ms(one_pass, reps=3, warm=1)
    counts = dict(kernels.launches)
    chk = [float(c) for c in sums['chk']]
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    print('phase 5 main path: B=%d, best of 3 %.3f ms = %.0f evals/s, '
          'checksums %s, peak %.2f GiB, launches %s (%s)' % (
              B, total_ms, B / (total_ms * 1e-3), ['%.6e' % c for c in chk],
              peak, counts, card))
    check(all(math.isfinite(c) for c in chk), 'non-finite checksum')
    check(counts['stage_a'] > 0 and counts['stage_b'] > 0,
          'main path did not launch both kernels: %s' % counts)

    # each stage alone, kernel and plain version, at the same B
    a = sj.stage_a(y_t, P_t)
    ms = {}
    ms['stage_a'] = best_ms(lambda: sj.stage_a(y_t, P_t))
    ms['stage_b'] = best_ms(lambda: sj.stage_b(a['src'], a['post']))
    ms['stage_a_plain'] = best_ms(
        lambda: stage_a_reference(packed, y_t, P_t, True), reps=2)
    ms['stage_b_plain'] = best_ms(
        lambda: stage_b_reference(sj.gidx, sj.nuc, sj.inv_mw, a['src'],
                                  a['post'], True), reps=2)
    # K2's library yardstick: the contraction on the gathered operand
    ms['stage_b_lib'] = best_ms(lambda: torch.bmm(sj.nuc, a['src'][sj.gidx]))
    for k in ('stage_a', 'stage_b'):
        print('  %s: kernel %.3f ms, plain version %.3f ms, library call %s '
              'ms (B=%d, %s)' % (k, ms[k], ms[k + '_plain'],
                                 '%.3f' % ms[k + '_lib'] if k + '_lib' in ms
                                 else 'none', B, card))
    J, N = sj.J, sj.N
    bounds = {
        'stage_a': stage_a_bound(sj, y_t, P_t, a),
        'stage_b': bound(nbytes(a['src'], a['post'], sj.col_ptr, sj.col_src,
                                sj.col_coef, sj.inv_mw) + 8 * J * N * B,
                         2 * len(sj.col_coef) * B + 8 * J * N * B)}
    return dict(counts=counts, ms=ms, total_ms=total_ms, bounds=bounds)


def stage_a_bound(sj, y_t, P_t, out):
    """K1's bound: the states and the tables it reads (K5's ``kp_``, the
    closure's ``kf_`` and ``ka_eff_val``) read once, its outputs ``out``
    written once."""
    tabs = [t for k, t in sj._buffers.items()
            if k.startswith(('kp_', 'kf_', 'ka_'))]
    return bound(nbytes(y_t, P_t, *tabs, *out.values()))


def stage_a_alone(sj, y_t, P_t, a, what, card):
    """K1 alone on ``sj``'s states beside its plain version and its bound
    (``a``: K1's outputs there): {'ms': {stage_a, stage_a_plain},
    'bound'}."""
    ms = {'stage_a': best_ms(lambda: sj.stage_a(y_t, P_t)),
          'stage_a_plain': best_ms(lambda: stage_a_reference(
              sj.packed, y_t, P_t, sj.conp), reps=2)}
    b = stage_a_bound(sj, y_t, P_t, a)
    B = y_t.shape[-1]
    print('  stage_a (%s): kernel %.3f ms, plain version %.3f ms, library '
          'call none, bound %.3f ms (%s) (B=%d, %s; %s)' % (
              what, ms['stage_a'], ms['stage_a_plain'], b[0], b[1], B,
              plan_tag(card_plan(sj, F64, B)), card))
    return {'ms': ms, 'bound': b}


def phase_stage_a_usc(packed, device, B, card):
    """Phase 5b (USC-II): K1 alone at the USC-II class beside its plain
    version and its bound, at the USC-II cell's B."""
    y_t, P_t = big_states(packed, B, device)
    sj = SparseJacobian(packed, device=device)
    a = sj.stage_a(y_t, P_t)
    stage_a_alone(sj, y_t, P_t, a, 'USC-II %d/%d' % (sj.N, sj.R), card)
    del sj, y_t, P_t, a
    torch.cuda.empty_cache()


def phase_synth_main(packed, device, B, card):
    """Phase 5b: the all-features synth at the flagship's width through
    ``SparseJacobian.call_tr`` at B, fused (K1 + K2) then unfused (K1, the
    gather, K2x), each timed as phase 5 with its counters set to 0 just
    before and read just after; the fused path's profiler split; K1's
    outputs at B held against ``stage_a_reference``'s, and K2's and K2x's
    J on those outputs against ``stage_b_reference``'s, at phase 3's
    tolerances; K1 alone beside its plain version and its bound; J and
    dy/dt against ``DenseJacobian`` (K4) on ``SYNTH_CROSS_B`` of the
    states, a check beside those gates."""
    y_t, P_t = big_states(packed, B, device)
    sj = SparseJacobian(packed, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    ms, counts, chk = timed_path(sj, y_t, P_t, ('stage_a', 'stage_b'))
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    print('phase 5b all-features synth %d/%d path: B=%d, best of 3 %.3f ms '
          '= %.0f evals/s, checksums %s, peak %.2f GiB, launches %s (%s)' % (
              sj.N, sj.R, B, ms, B / (ms * 1e-3), ['%.6e' % c for c in chk],
              peak, counts, card))
    print_profile('synth path', lambda: [torch.sum(x)
                                         for x in sj.call_tr(y_t, P_t)],
                  card, split=(('K1', 'sparse_stage_a'),
                               ('K2', 'sparse_stage_b')),
                  rest='checksum reductions',
                  need={'sparse_stage_a': 3, 'sparse_stage_b': 3})
    res = {'counts': counts, 'total_ms': ms, 'ms': {}}
    # K1, then K2 on K1's outputs, against their plain versions at B
    tag = 'synth53 conp B=%d' % B
    a = sj.stage_a(y_t, P_t)
    ref = stage_a_reference(packed, y_t, P_t, True)
    gate_stage_a(sj, y_t, P_t, a, ref, tag)
    del ref
    gate_stage_b(sj, tag, sj.stage_b(a['src'], a['post']),
                 stage_b_reference(sj.gidx, sj.nuc, sj.inv_mw, a['src'],
                                   a['post'], True), a)
    torch.cuda.empty_cache()
    res.update(stage_a_alone(sj, y_t, P_t, a, 'synth', card))
    del a
    # J and dy/dt against K4 on a slice
    Bc = SYNTH_CROSS_B
    yc, Pc = y_t[:, :Bc].contiguous(), P_t[:, :Bc].contiguous()
    Jd, fd = DenseJacobian(packed, device=device).call_tr(yc, Pc)
    cols, col0, fs = sj.call_tr(yc, Pc)
    ex = floored(full_J(cols, col0), Jd, 1e-10)
    exf = state_rel(fs, fd)
    print('  synth vs DenseJacobian (K4), B=%d: J floored@1e-10 %.3e (<= '
          '%.0e), dy/dt per state %.3e (<= %.0e)' % (Bc, ex, TOL_CROSS, exf,
                                                     TOL_NET))
    check(ex <= TOL_CROSS, 'synth: SparseJacobian vs DenseJacobian J %.3e'
          % ex)
    check(exf <= TOL_NET, 'synth: SparseJacobian vs DenseJacobian dy/dt '
          '%.3e' % exf)
    cols_fused = cols
    del Jd, fd, col0, fs, sj
    torch.cuda.empty_cache()
    # the unfused path
    sx = SparseJacobian(packed, fuse_gather=False, device=device)
    msx, cx, chkx = timed_path(sx, y_t, P_t, ('stage_a', 'stage_b_x'))
    check(cx['stage_b'] == 0, 'the unfused synth path launched K2')
    res.update(counts_unfused=cx, total_ms_unfused=msx)
    ex = floored(sx.call_tr(yc, Pc)[0], cols_fused, 1e-10)
    print('phase 5b all-features synth fuse_gather=False path: B=%d, best of '
          '3 %.3f ms = %.0f evals/s, checksums %s, launches %s; J vs the '
          'fused path (B=%d) floored@1e-10 %.3e (<= %.0e) (%s)' % (
              B, msx, B / (msx * 1e-3), ['%.6e' % c for c in chkx], cx, Bc,
              ex, TOL_J, card))
    check(ex <= TOL_J, 'synth: unfused vs fused J %.3e' % ex)
    del cols_fused
    # K2x on K1's outputs against its plain version at B
    a = sx.stage_a(y_t, P_t)
    gate_stage_b(sx, tag, *k2x_vs_plain(sx, a), a, what='K2x')
    del sx, y_t, P_t, a
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the large-mechanism pipeline
# ---------------------------------------------------------------------------

def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, n_ops=0.0, flop_s=F64_FLOP_S):
    """(least ms, 'bytes' or 'operations') for moving ``n_bytes`` through
    HBM once and doing ``n_ops`` operations at ``flop_s`` (f64 unless
    said)."""
    tb = n_bytes / HBM_BYTES_S * 1e3
    to = n_ops / flop_s * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


def own_density(packed, y_t, P_t):
    """Each state's own density (CONV takes density, so the rates stay
    those of a real state)."""
    inv_mw = torch.as_tensor(packed.inv_mw, device=y_t.device)
    Yf = torch.cat([y_t[1:], 1.0 - y_t[1:].sum(0, keepdim=True)])
    return (P_t / (RU * y_t[:1] * (Yf * inv_mw[:, None]).sum(
        0, keepdim=True))).contiguous()


def big_states(packed, B, device):
    y, _, P = random_states(packed.mech, B, seed=3)
    return to_tr(y, P, device)


def big_dcol(mod, roles):
    """The plain raw contraction (J, N, B) of ``mod``'s column kernel (K6
    or K7) from the role array."""
    J, B = mod.J, roles.shape[-1]
    if mod.sparse_cols:
        p1c = mod.assemble_p1c(source_stack(roles, mod.Sf + mod.Sp,
                                            mod.eff_val))
        return torch.einsum('jnr,jrb->jnb', mod.ks_nuc,
                            p1c.view(J, mod.Rmax, B))
    return dense_dcol(mod.tab('kd_'), roles, mod.Sf, mod.Sp)


def dense_dcol(td, roles, Sf, Sp):
    """The dense plain contraction (J, N, B) of K7 / K4 from the role
    array and the ``dense_col_tables`` tensors ``td``."""
    J = td['nu_net'].shape[1] - 1
    return torch.stack([td['nu_net'].T @ p1_dense(
        roles, Sf, Sp, td['spf'], td['spp'], td['eff'], td['pd'], j)
        for j in range(J)], 0)


def dense_magnitudes(td, roles, post, Sf, Sp, last, q_gross):
    """The summed magnitudes of the products the sums behind a J column
    add: (J, N, B) for each column's operand contraction, |nu_net|^T @
    (the magnitudes of column j's operand roles); (N, B) for ``v_u`` and
    ``v_c`` (``last``: ``finish_coefs``' at_last / pd_last tensors); and
    (1, B) for dy/dt's temperature row fT = -sum_n eWn_n (nu_net^T q)_n,
    sum_n |eWn_n| (|nu_net|^T q_gross)_n, with ``q_gross`` (R, B) =
    |pm| (|Rf| + |Rr|), the magnitude of each net rate's terms."""
    J = td['nu_net'].shape[1] - 1
    N = J + 1
    nu_abs = td['nu_net'].abs().T
    k = Sf + Sp
    a, b = post_rows(N, J)['eWn']
    fT = (post[a:b].abs() * (nu_abs @ q_gross)).sum(0, keepdim=True)
    vu = nu_abs @ roles[k + 2].abs()
    vc = nu_abs @ (roles[k + 3].abs() +
                   (roles[k + 4] * last['at_last'][:, None]).abs() +
                   (roles[k + 5] * last['pd_last'][:, None]).abs())
    out = []
    for j in range(J):
        acc = roles[k + 4].abs() * td['eff'][:, j:j + 1].abs()
        acc = acc + torch.where((td['pd'] == j)[:, None], roles[k + 5].abs(),
                                0.0)
        for s in range(Sf):
            acc = acc + torch.where((td['spf'][:, s] == j)[:, None],
                                    roles[s].abs(), 0.0)
        for s in range(Sp):
            acc = acc + torch.where((td['spp'][:, s] == j)[:, None],
                                    roles[Sf + s].abs(), 0.0)
        out.append(nu_abs @ acc)
    return torch.stack(out, 0), vu, vc, fT


def t_row_gross(dcol, inv_mw, post, conp, mags=None):
    """(J, B): for each column, the summed magnitude of the terms its
    temperature row adds (``post_col_reference``'s JTY: the N terms
    eWn * dcol and the fT term), from the plain contraction ``dcol``.
    With ``mags`` (:func:`dense_magnitudes`; then ``dcol`` gives only the
    shape) the products of the sums behind dcol, v_u, v_c and fT count
    too: a kernel that sums them in another order than its plain version
    rounds on their scale."""
    N = dcol.shape[1]
    J = N - 1
    g = {k: post[a:b] for k, (a, b) in post_rows(N, J).items()}
    w = inv_mw[:J]
    u = w - inv_mw[N - 1]
    if mags is None:
        d = dcol * w[:, None, None] + g['v_u'][None] * u[:, None, None] + \
            g['v_c'][None]
    else:
        d = (mags[0] * w[:, None, None] +
             mags[1][None] * u.abs()[:, None, None] + mags[2][None])
    r = -(g['mw_avg'] * u[:, None]) if conp else 0.0
    fT = g['fT'] if mags is None else mags[3]
    return ((g['eWn'][None] * d).abs().sum(1) +
            (fT * (r + (g['cp'][:J] - g['cp'][N - 1]) * g['ish'])).abs())


def phase_big_kernels(cases, device, card):
    """Phase 6: K5 and the column kernels of each case (K6 and/or K7)
    against their plain versions, same inputs; the case marked ``main``
    for a kernel gives its ``max_abs_err`` (CONP)."""
    res = {}
    for name, packed, B, cols, main in cases:
        y_t, P_t = big_states(packed, B, device)
        for conp in (True, False):
            param = P_t if conp else own_density(packed, y_t, P_t)
            mods = {'K6': BigJacobian(packed, conp=conp, device=device)
                    if 'K6' in cols else None,
                    'K7': BigJacobian(packed, conp=conp, device=device,
                                      **BIG_DENSE) if 'K7' in cols else None}
            bj = mods['K6'] or mods['K7']
            st = state_thermo(bj.packed, y_t, param, conp)
            ref = parts_reference(bj.packed, st, conp)
            got = bj.parts(st)
            torch.cuda.synchronize()
            k = bj.Sf + bj.Sp
            errs = {
                'K5 vals': (row_rel(got[:k], ref[:k]), TOL_ELEMENTWISE)}
            for i, role in enumerate(ROLE_NAMES):
                tol = (TOL_ELEMENTWISE if role in ('c_u', 'c_1')
                       else TOL_ROLE_NET)
                errs['K5 ' + role] = (row_rel(got[k + i], ref[k + i]), tol)
            maxe = {'big_parts': float((got - ref).abs().max())}
            del got
            post = finish(bj.packed, st, ref, conp)['post']
            tag = '%s %s B=%d' % (name, 'conp' if conp else 'conv', B)
            for kn, kname in (('K6', 'big_cols_sparse'),
                              ('K7', 'big_cols_dense')):
                mod = mods[kn]
                if mod is None:
                    continue
                check(mod.perm is None and bj.perm is None or
                      np.array_equal(mod.perm, bj.perm),
                      'permutations differ')
                got = mod.columns(ref, post)
                plain = (cols_sparse_reference(
                    mod.assemble_p1c(source_stack(ref, k, mod.eff_val)),
                    mod.ks_nuc, mod.inv_mw, post, conp) if kn == 'K6'
                    else cols_dense_reference(ref, mod.tab('kd_'),
                                              mod.inv_mw, post, conp))
                torch.cuda.synchronize()
                e = floored_err(got, plain, 1e-10)
                gross = t_row_gross(big_dcol(mod, ref), mod.inv_mw, post,
                                    conp)
                errs[kn + ' J T'] = (float(
                    ((got[:, 0] - plain[:, 0]).abs() / gross).max()),
                    TOL_BIG_JT)
                errs[kn + ' J Y'] = (float(e[:, 1:].max()), TOL_BIG_J)
                print('  %s %s J T floored@1e-10 %.3e' % (
                    tag, kn, float(e[:, :1].max())))
                del e, gross
                maxe[kname] = float((got - plain).abs().max())
                del got, plain
                torch.cuda.empty_cache()
            for nm, (err, tol) in errs.items():
                print('  %s %-10s %.3e (<= %.0e)' % (tag, nm, err, tol))
            for nm, (err, tol) in errs.items():
                check(err <= tol, '%s %s: %.3e > %.0e' % (tag, nm, err, tol))
            if conp:
                res.update({kn: e for kn, e in maxe.items() if kn in main})
            del ref, post, st, mods, bj
            torch.cuda.empty_cache()
    print('phase 6 big kernels vs plain: ok (%s)' % card)
    return res


def phase_big_golden(mechs, device, card):
    """Phase 7: both reference-C goldens through BigJacobian."""
    for name, packed in mechs:
        g = np.load(os.path.join(DATA, 'golden_%s_refc.npz' % name))
        for cfg, kw in (('sparse', {}), ('dense', BIG_DENSE)):
            errJ, errf = golden_errs(BigJacobian(packed, device=device, **kw),
                                     g)
            print('phase 7 golden %s (%s): J floored@1e-10 %.3e (< %.0e), '
                  'dy/dt norm-rel %.3e (< %.0e) (%s)' % (
                      name, cfg, errJ, TOL_GOLDEN_J, errf, TOL_GOLDEN_F,
                      card))
            check(errJ < TOL_GOLDEN_J, 'golden %s %s J %.3e' % (name, cfg,
                                                                errJ))
            check(errf < TOL_GOLDEN_F, 'golden %s %s dy/dt %.3e'
                  % (name, cfg, errf))


def timed_path(mod, y_t, P_t, need):
    """One main-path run: counters set to 0, warm-up + best of 3 passes,
    counters read; checks every kernel in ``need`` launched."""
    sums = {}

    def one_pass():
        out = mod.call_tr(y_t, P_t)
        sums['chk'] = [torch.sum(x) for x in out]

    kernels.reset_launches()
    ms = best_ms(one_pass, reps=3, warm=1)
    counts = dict(kernels.launches)
    chk = [float(c) for c in sums['chk']]
    check(all(math.isfinite(c) for c in chk), 'non-finite checksum')
    check(all(counts[k] > 0 for k in need),
          'main path did not launch %s: %s' % (need, counts))
    return ms, counts, chk


def device_profile(fn, n=3):
    """Device time by kernel over ``n`` calls of ``fn`` from a
    ``torch.profiler`` trace: (ms per call of the CUDA-event wall,
    busy ms per call, [(kernel name, ms per call)] largest first,
    {kernel name: records in the trace})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
    rows, counts = {}, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            rows[ev.name] = rows.get(ev.name, 0.0) + ev.device_time / 1e3 / n
            counts[ev.name] = counts.get(ev.name, 0) + 1
    busy = sum(rows.values())
    return (s.elapsed_time(e) / n, busy,
            sorted(rows.items(), key=lambda kv: -kv[1]), counts)


BIG_SPLIT = (('K5', 'big_parts'), ('K6', 'big_cols_sparse'),
             ('K7', 'big_cols_dense'))


def print_profile(tag, fn, card, split=BIG_SPLIT,
                  rest='plain torch (pre-stage, finish, assembly)',
                  need=None, takes=3):
    """Print the device-time profile of ``fn`` and its stage split: the
    port's kernels of ``split`` ((label, kernel name part) pairs) by name,
    every other kernel (``rest``) together.  ``need`` ({kernel name part:
    its launches in the 3 calls}): late in a long run the card's tracer
    has dropped the record of a trace's first K3 launch, so a trace short
    of a kernel's records is retaken, up to ``takes`` times, and then the
    profile is not measured."""
    for _ in range(takes):
        wall, busy, rows, counts = device_profile(fn)
        short = {part: (sum(c for nm, c in counts.items() if part in nm),
                        want) for part, want in (need or {}).items()}
        short = {part: gw for part, gw in short.items() if gw[0] < gw[1]}
        if not short:
            break
        print('  %s profile: the trace lost kernel records (%s)' % (
            tag, ', '.join('%s %d of %d' % (p, *gw)
                           for p, gw in short.items())))
    else:
        print('  %s profile: every take lost kernel records (not measured)'
              % tag)
        return
    if busy <= 0.0:
        print('  %s profile: no device time in the trace (not measured)'
              % tag)
        return
    print('  %s profile (torch.profiler, 3 passes, %s): pass %.3f ms, '
          'device busy %.3f ms, idle share %.1f%%; by kernel per pass:'
          % (tag, card, wall, busy, 100.0 * (1.0 - busy / wall)))
    for name, ms in rows[:10]:
        print('    %8.3f ms %5.1f%%  %s' % (ms, 100.0 * ms / busy, name[:90]))
    print('    %8.3f ms in %d other kernels' % (
        sum(ms for _, ms in rows[10:]), max(len(rows) - 10, 0)))
    own = [(label, sum(ms for n, ms in rows if k in n)) for label, k in split]
    print('  %s stage split, device ms per pass: %s, %s %.3f, idle %.3f'
          % (tag, ', '.join('%s %.3f' % kv for kv in own), rest,
             busy - sum(ms for _, ms in own), wall - busy))


def full_J(cols, col0):
    return torch.cat([col0[None], cols], 0)


def dense_bound(bd, roles, post, B):
    """K7's bound from this run's tables: its inputs (the role rows, the
    post rows and the tables it reads) read once and its output written
    once, and the nonzero products the function needs (per column, the
    reactions whose operand is nonzero there times the nonzero nu_net
    entries of each).  Also returns the floor of the dense contraction
    over all R that the TPU kernel does, 2 J N R B operations."""
    td = bd.tab('kd_')
    J, N, R = bd.J, bd.N, bd.R
    cols = torch.arange(J, device=roles.device)
    part = ((td['spf'][:, :, None] == cols).any(1) |
            (td['spp'][:, :, None] == cols).any(1) |
            (td['eff'][:, :J] != 0) | (td['pd'][:, None] == cols))
    nnz = (td['nu_net'] != 0).sum(1)
    products = float((part.double() * nnz[:, None]).sum()) * B
    read = [v for k, v in td.items() if k != 'nu_net']
    b = bound(nbytes(roles[:bd.Sf + bd.Sp], roles[-2:], post, *read,
                     bd.inv_mw) + 8 * J * N * B, 2.0 * products)
    return b, 2.0 * products, bound(0, 2.0 * J * N * R * B)[0]


def phase_big_main(mechs, sizes, device, card):
    """Phase 8: the large-mechanism paths at full width, ``sizes`` the
    batch of each path."""
    p654, p_usc = mechs['654'], mechs['usc']
    res = {'ms': {}}
    k = res['ms']
    # --- a. the 654-class default configuration at B = 1024 ----------------
    B = sizes['654']
    y_t, P_t = big_states(p654, B, device)
    bj = BigJacobian(p654, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    ms, counts, chk = timed_path(bj, y_t, P_t,
                                 ('big_parts', 'big_cols_sparse'))
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    res['counts_654'] = counts
    print('phase 8a 654-class default path: B=%d, best of 3 %.3f ms = %.0f '
          'evals/s, checksums %s, peak %.2f GiB, launches %s, split r1=%s '
          '(%s)' % (B, ms, B / (ms * 1e-3), ['%.6e' % c for c in chk], peak,
                    counts, bj.split_r1, card))
    print_profile('654 default path', lambda: bj.call_tr(y_t, P_t), card)
    cols, col0, f = bj.call_tr(y_t, P_t)
    J1 = full_J(cols, col0)
    del cols
    sj = SparseJacobian(p654, device=device)
    cs, cs0, fs = sj.call_tr(y_t, P_t)
    ex = floored(full_J(cs, cs0), J1, 1e-10)
    exf = state_rel(fs[1:], f[1:])
    del cs
    print('  654 vs SparseJacobian (K1/K2): J floored %.3e (<= %.0e), dy/dt '
          'species per state %.3e' % (ex, TOL_CROSS, exf))
    check(ex <= TOL_CROSS, 'BigJacobian vs SparseJacobian J %.3e' % ex)
    del J1, sj
    torch.cuda.empty_cache()

    # stage split and each kernel alone at this shape
    st = state_thermo(bj.packed, y_t, P_t, True)
    roles = bj.parts(st)
    post = finish(bj.packed, st, roles, True)['post']
    p1c = bj.assemble_p1c(source_stack(roles, bj.Sf + bj.Sp, bj.eff_val))

    def front():
        s2 = state_thermo(bj.packed, y_t, P_t, True)
        r2 = bj.parts(s2)
        finish(bj.packed, s2, r2, True)
        bj.assemble_p1c(source_stack(r2, bj.Sf + bj.Sp, bj.eff_val))

    k['front'] = per_call_ms(front)
    k['big_cols_sparse'] = per_call_ms(
        lambda: kernels.big_cols_sparse(bj, p1c, post))
    k['big_parts'] = per_call_ms(lambda: bj.parts(st))
    k['big_parts_plain'] = best_ms(
        lambda: parts_reference(bj.packed, st, True), reps=2)
    k['big_cols_sparse_plain'] = best_ms(
        lambda: cols_sparse_reference(p1c, bj.ks_nuc, bj.inv_mw, post,
                                      True), reps=2)
    p1c3 = p1c.view(bj.J, bj.Rmax, B)
    k['big_cols_sparse_lib'] = per_call_ms(lambda: torch.bmm(bj.ks_nuc,
                                                             p1c3))
    print('  stage split, CUDA events over 10 queued calls each (B=%d): '
          'pre-stage + K5 + finish + assembly %.3f ms, column kernel K6 '
          '%.3f ms (%s)' % (B, k['front'], k['big_cols_sparse'], card))
    tabs = [v for n, v in bj._buffers.items() if n.startswith('kp_')]
    res['bounds'] = {
        'big_parts': bound(nbytes(st['rows'], *tabs, roles)),
        'big_cols_sparse': bound(
            nbytes(p1c, post, bj.ks_ptr, bj.ks_src, bj.ks_coef, bj.inv_mw) +
            8 * bj.J * bj.N * B,
            2 * bj.ks_coef.numel() * B + 8 * bj.J * bj.N * B)}
    del st, roles, post, p1c, p1c3
    torch.cuda.empty_cache()

    # --- b. the USC-II class at B = 32768 ------------------------------------
    Bu = sizes['usc']
    yu, Pu = big_states(p_usc, Bu, device)
    bu = BigJacobian(p_usc, device=device)
    msu, cu, chku = timed_path(bu, yu, Pu, ('big_parts', 'big_cols_sparse'))
    res['counts_usc'] = cu
    print('phase 8b USC-II class default path: B=%d, best of 3 %.3f ms = '
          '%.0f evals/s, checksums %s, launches %s (%s)' % (
              Bu, msu, Bu / (msu * 1e-3), ['%.6e' % c for c in chku], cu,
              card))
    print_profile('USC-II default path', lambda: bu.call_tr(yu, Pu), card)
    cols, col0, _ = bu.call_tr(yu, Pu)
    Ju = full_J(cols, col0)
    del cols
    cs, cs0, _ = SparseJacobian(p_usc, device=device).call_tr(yu, Pu)
    exu = floored(full_J(cs, cs0), Ju, 1e-10)
    del cs, Ju
    print('  USC-II vs SparseJacobian (K1/K2): J floored %.3e (<= %.0e)'
          % (exu, TOL_CROSS))
    check(exu <= TOL_CROSS, 'USC-II vs SparseJacobian J %.3e' % exu)
    del yu, Pu, bu
    torch.cuda.empty_cache()

    # --- c. the dense K7 configuration at the 654 class, B = 512 ----------
    Bd = sizes['654_dense']
    yd, Pd = y_t[:, :Bd].contiguous(), P_t[:, :Bd].contiguous()
    bd = BigJacobian(p654, device=device, **BIG_DENSE)
    msd, cd, chkd = timed_path(bd, yd, Pd, ('big_parts', 'big_cols_dense'))
    res['counts_654_dense'] = cd
    cols, col0, _ = bd.call_tr(yd, Pd)
    cs, cs0, _ = bj.call_tr(yd, Pd)
    exd = floored(full_J(cols, col0), full_J(cs, cs0), 1e-10)
    del cols, cs
    print('phase 8c 654-class dense K7 path: B=%d, best of 3 %.3f ms = %.0f '
          'evals/s, checksums %s, launches %s; vs the default path J floored '
          '%.3e (<= %.0e) (%s)' % (Bd, msd, Bd / (msd * 1e-3),
                                   ['%.6e' % c for c in chkd], cd, exd,
                                   TOL_CROSS, card))
    check(exd <= TOL_CROSS, 'dense vs sparse J %.3e' % exd)
    st = state_thermo(bd.packed, yd, Pd, True)
    roles = bd.parts(st)
    post = finish(bd.packed, st, roles, True)['post']
    td = bd.tab('kd_')
    k['big_cols_dense'] = best_ms(lambda: bd.columns(roles, post))
    k['big_cols_dense_plain'] = best_ms(
        lambda: cols_dense_reference(roles, td, bd.inv_mw, post, True),
        reps=2)
    J_, R_ = bd.J, bd.R
    P_all = torch.empty((R_, J_ * Bd), dtype=F64, device=device)
    for j in range(J_):
        P_all[:, j * Bd:(j + 1) * Bd] = p1_dense(
            roles, bd.Sf, bd.Sp, td['spf'], td['spp'], td['eff'], td['pd'],
            j)
    nuT = td['nu_net'].T.contiguous()
    k['big_cols_dense_lib'] = best_ms(lambda: torch.matmul(nuT, P_all))
    res['bounds']['big_cols_dense'], ops7, dense7 = dense_bound(
        bd, roles, post, Bd)
    print('  K7 bound counts %.4e nonzero-product operations (%d CSR '
          'entries); the dense contraction of the TPU kernel (2 J N R B = '
          '%.4e) has a floor of %.3f ms at the f64 tensor-core peak' % (
              ops7, td['src'].numel(), 2.0 * J_ * bd.N * R_ * Bd, dense7))
    del st, roles, post, P_all
    torch.cuda.empty_cache()
    # K7 alone at the default path's shape, beside K6 there (phase 8a)
    st = state_thermo(bd.packed, y_t, P_t, True)
    roles = bd.parts(st)
    post = finish(bd.packed, st, roles, True)['post']
    k['big_cols_dense_B%d' % B] = per_call_ms(
        lambda: kernels.big_cols_dense(bd, roles, post))
    print('  column kernels alone at the 654 class, B=%d: K7 %.3f ms, K6 '
          '%.3f ms (%s)' % (B, k['big_cols_dense_B%d' % B],
                            k['big_cols_sparse'], card))
    del st, roles, post
    torch.cuda.empty_cache()
    for nm, shape in (('big_parts', 'B=%d' % B),
                      ('big_cols_sparse', 'B=%d' % B),
                      ('big_cols_dense', 'B=%d' % Bd)):
        print('  %s: kernel %.3f ms, plain version %.3f ms, library call %s '
              'ms, bound %.3f ms (%s) (654 class, %s, %s)' % (
                  nm, k[nm], k[nm + '_plain'],
                  '%.3f' % k[nm + '_lib'] if nm + '_lib' in k else 'none',
                  res['bounds'][nm][0], res['bounds'][nm][1], shape, card))
    return res


# ---------------------------------------------------------------------------
# the dense fused kernel K4, K2x and the integrator
# ---------------------------------------------------------------------------


def phase_dense_kernels(cases, device, card):
    """Phase 9a: K4 against ``dense_reference`` on the same inputs, CONP
    and CONV: J's column 0 as phase 3 gates col0, columns 1..J's species
    rows floored and their temperature row on the summed magnitude of its
    terms (as phase 6, with the contraction's own terms: K4 contracts the
    operand's roles one by one, the plain version adds them per reaction
    first), f as phase 3.  Each case (name, packed, B, main, placement)
    runs the planner's tile, or its own placement where one is given;
    the case marked ``main`` gives the row's ``max_abs_err`` (CONP)."""
    res = {}
    for name, packed, B, main, placement in cases:
        y_t, P_t = case_states(name, packed, B, device)
        for conp in (True, False):
            param = P_t if conp else own_density(packed, y_t, P_t)
            dj = DenseJacobian(packed, conp=conp, device=device)
            plan = card_plan(dj, F64, B, placement)
            got, gf = kernels.dense_fused(dj, y_t, param, plan=plan)
            ref, rf = dense_reference(packed, y_t, param, conp)
            torch.cuda.synchronize()
            errs = {'col0 T': (row_rel(got[0, :1], ref[0, :1]), TOL_NET),
                    'col0 Y': (state_rel(got[0, 1:], ref[0, 1:]), TOL_NET),
                    'f T': (row_rel(gf[:1], rf[:1]), TOL_NET),
                    'f Y': (state_rel(gf[1:], rf[1:]), TOL_NET),
                    'f Y on terms': (on_terms(
                        gf[1:] - rf[1:], f_gross(packed, y_t, param, conp)),
                        TOL_F_GROSS)}
            e = floored_err(got, ref, 1e-10)
            tag = 'K4 %s %s B=%d (%s)' % (name, 'conp' if conp else 'conv',
                                          B, plan_tag(plan))
            errs['J Y'] = (float(e[1:, 1:].max()),
                           TOL_CROSS if name in BIG_CLASSES else TOL_BIG_J)
            print('  %s J T floored@1e-10 %.3e' % (tag,
                                                  float(e[1:, :1].max())))
            del e
            gross = dense_t_gross(packed, y_t, param, conp)
            errs['J T'] = (float(((got[1:, 0] - ref[1:, 0]).abs() /
                                  gross).max()), TOL_BIG_JT)
            for nm, (err, tol) in errs.items():
                print('  %s %-11s %.3e (<= %.0e)' % (tag, nm, err, tol))
            for nm, (err, tol) in errs.items():
                check(err <= tol, '%s %s: %.3e > %.0e' % (tag, nm, err, tol))
            if conp and main:
                res['dense_fused'] = float((got - ref).abs().max())
            del got, ref, gf, rf, gross, dj
            torch.cuda.empty_cache()
    print('phase 9a K4 vs plain: ok (%s)' % card)
    return res


def dense_t_gross(packed, y_t, param, conp):
    """(J, B) float64: for each column 1..J of the dense kernels' J (K4,
    K3), the summed magnitude of the products behind its temperature-row
    entry (:func:`t_row_gross` with :func:`dense_magnitudes`), from the
    float64 plain pieces on the states ``y_t`` and ``param``."""
    device = y_t.device
    st = state_thermo(packed, y_t, param, conp)
    roles = parts_reference(packed, st, conp)
    post = finish(packed, st, roles, conp)['post']
    td = {k: torch.as_tensor(v, device=device)
          for k, v in dense_col_tables(packed).items()}
    Sf, Sp = packed.reac_sp.shape[1], packed.prod_sp.shape[1]
    last = {k: torch.as_tensor(v, device=device)
            for k, v in finish_coefs(packed).items()}
    rp = reaction_parts(packed, param[0], y_t.T, conp)
    q_gross = (rp['pm'].abs() * (rp['Rf'].abs() + rp['Rr'].abs())).T
    del rp
    mags = dense_magnitudes(td, roles, post, Sf, Sp, last, q_gross)
    inv_mw = torch.as_tensor(packed.inv_mw, dtype=F64, device=device)
    return t_row_gross(mags[0], inv_mw, post, conp, mags=mags)


def dense_ops(mod, B):
    """The operations K4 / K3 (``mod``: a ``DenseJacobian`` or an
    ``F32Jacobian``) needs for B states, counted from its tables: per
    state the thermo (ln T, 50 per species), per reaction 40, 4 per entry
    of its Kc sum and the exp / log / pow calls its categories make
    (:data:`TRANSCENDENTAL_OPS` each: kf; Kc's exp when reversible; the
    low- or high-pressure rate and log10 Pr under falloff; Troe's 4 (5
    with T2); SRI's 7 (2 exp, 2 pow at 2 each, a log); PLOG's and
    Chebyshev's 2; 4 a slot with fractional nu), the contractions (8 per
    nu_net entry: four sums of products), the closure (12 per species),
    the column operand's products (2 per CSR entry) and `_post_col` (8
    per J entry)."""
    fl = mod.kp_flags.cpu().numpy()
    plog = (mod.kp_plog_pos >= 0).cpu().numpy()
    cheb = (mod.kp_cheb_pos >= 0).cpu().numpy()
    p = mod.packed
    N, R, J = mod.N, mod.R, mod.N - 1
    calls = (1 + (fl & 1 != 0) + 2 * (fl & (4 | 8) != 0) +
             (fl & 16 != 0) * (4 + (fl & 64 != 0)) + 7 * (fl & 32 != 0) +
             2 * plog + 2 * cheb).sum()
    if p.has_frac_nu:
        calls += 4 * R * (p.reac_sp.shape[1] + p.prod_sp.shape[1])
    nnz = int((np.asarray(p.nu_net) != 0).sum())
    per_state = (TRANSCENDENTAL_OPS * (1 + float(calls)) + 50.0 * N +
                 40.0 * R + 4.0 * int(mod.kp_nu_ptr[-1]) + 8.0 * nnz +
                 12.0 * N + 2.0 * mod.kf_col_coef.numel() + 8.0 * J * N)
    return per_state * B


def k2x_vs_plain(sx, a):
    """(K2x's J, ``stage_b_reference``'s) on the operand gathered from K1's
    outputs ``a`` by the unfused module ``sx``."""
    p1 = sx.stage_gather(a['src'])
    got = sx.stage_b_x(p1, a['post'])
    rows = torch.arange(sx.J * sx.Rmax, device=p1.device).view(sx.J,
                                                               sx.Rmax)
    return got, stage_b_reference(rows, sx.nuc, sx.inv_mw, p1, a['post'],
                                  sx.conp)


def phase_k2x(packed, device, B, card):
    """Phase 9b: K2x against ``stage_b_reference`` on the gathered operand,
    the same K1 outputs, at the timed shape (phase 11d)."""
    sx = SparseJacobian(packed, fuse_gather=False, device=device)
    y_t, P_t = to_tr(*flagship_states(B), device)
    got, ref = k2x_vs_plain(sx, sx.stage_a(y_t, P_t))
    torch.cuda.synchronize()
    err = floored(got, ref, 1e-10)
    print('phase 9b K2x vs plain: J floored@1e-10 %.3e (<= %.0e) (B=%d, %s)'
          % (err, TOL_J, B, card))
    check(err <= TOL_J, 'K2x: %.3e > %.0e' % (err, TOL_J))
    return {'stage_b_x': float((got - ref).abs().max())}


def phase_dense_golden(mechs, device, card):
    """Phase 10: both goldens through DenseJacobian (K4), the flagship
    through SparseJacobian(fuse_gather=False) (K1, K2x)."""
    runs = [(name, 'DenseJacobian', DenseJacobian(p, device=device))
            for name, p in mechs]
    runs.append(('flagship', 'SparseJacobian(fuse_gather=False)',
                 SparseJacobian(mechs[0][1], fuse_gather=False,
                                device=device)))
    for name, what, mod in runs:
        g = np.load(os.path.join(DATA, 'golden_%s_refc.npz' % name))
        errJ, errf = golden_errs(mod, g)
        print('phase 10 golden %s (%s): J floored@1e-10 %.3e (< %.0e), dy/dt '
              'norm-rel %.3e (< %.0e) (%s)' % (name, what, errJ, TOL_GOLDEN_J,
                                               errf, TOL_GOLDEN_F, card))
        check(errJ < TOL_GOLDEN_J, 'golden %s %s J %.3e' % (name, what, errJ))
        check(errf < TOL_GOLDEN_F, 'golden %s %s dy/dt %.3e' % (name, what,
                                                                 errf))


def integrate_profile(fn, iters, card):
    """Device time per loop iteration of one integrate call ``fn``: K4 by
    kernel name, the LU factor + solves and dy/dt by ``record_function``
    ranges around the integrator's calls, the rest of the plain torch
    arithmetic, and idle (the CUDA-event wall minus device busy)."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    # the module (the package exports the function under the same name)
    integ = importlib.import_module('pyjac_tpu_torch.integrate')

    def ranged(name, f):
        def g(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return g

    saved = (integ.dydt_dispatch, integ.lu_factor, integ.lu_solve)
    integ.dydt_dispatch = ranged('smoke.dydt', saved[0])
    integ.lu_factor = ranged('smoke.lu_factor', saved[1])
    integ.lu_solve = ranged('smoke.lu_solve', saved[2])
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
    finally:
        integ.dydt_dispatch, integ.lu_factor, integ.lu_solve = saved
    wall = s.elapsed_time(e)
    busy = k4 = 0.0
    ranges = {'smoke.dydt': 0.0, 'smoke.lu_factor': 0.0,
              'smoke.lu_solve': 0.0}
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and ev.name not in ranges:
            # (a range's own span on the device timeline is not busy
            # time: its kernels are counted one by one)
            t = ev.device_time / 1e3
            busy += t
            by_name[ev.name] = by_name.get(ev.name, 0.0) + t
            if 'dense_fused' in ev.name:
                k4 += t
        elif ev.device_type == DeviceType.CPU and ev.name in ranges:
            ranges[ev.name] += ev.device_time_total / 1e3
    if busy <= 0.0:
        print('  integrate profile: no device time in the trace (not '
              'measured)')
        return None
    n = float(iters)
    split = dict(K4=k4 / n, lu_factor=ranges['smoke.lu_factor'] / n,
                 lu_solve=ranges['smoke.lu_solve'] / n,
                 dydt=ranges['smoke.dydt'] / n)
    split['other'] = busy / n - sum(split.values())
    split['idle'] = (wall - busy) / n
    print('  integrate profile (torch.profiler, one call, %d iterations, %s): '
          'wall %.3f ms, device busy %.3f ms, idle share %.1f%%' % (
              iters, card, wall, busy, 100.0 * (1.0 - busy / wall)))
    print('  per iteration, device ms: K4 %.3f, LU factor %.3f, LU solves '
          '%.3f, plain-torch dy/dt %.3f, other plain torch %.3f, idle %.3f'
          % (split['K4'], split['lu_factor'], split['lu_solve'],
             split['dydt'], split['other'], split['idle']))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print('    %9.3f ms %5.1f%%  %s' % (ms, 100.0 * ms / busy, name[:90]))
    return split


def integrate_summary(res):
    st = res.status.cpu().numpy()
    steps = res.steps.cpu().numpy()
    rej = res.rejected.cpu().numpy()
    hist = {int(k): int(v) for k, v in zip(*np.unique(st, return_counts=True))}
    return ('steps min/median/max %d/%d/%d, rejections %d (max %d per '
            'state), status histogram %s, %d iterations' % (
                steps.min(), np.median(steps), steps.max(), rej.sum(),
                rej.max(), hist, res.iterations)), hist


def same_run(a, b, what):
    """Phase 11 gate: equal steps, rejections and status per state, and
    endpoints floored@1e-10 within TOL_INTEGRATE."""
    for k in ('steps', 'rejected', 'status'):
        check(torch.equal(getattr(a, k), getattr(b, k)),
              '%s: %s differ' % (what, k))
    err = floored(a.y.T, b.y.T, 1e-10)
    check(err <= TOL_INTEGRATE, '%s: endpoints %.3e > %.0e' % (
        what, err, TOL_INTEGRATE))
    return err


def phase_integrate(packed, device, sizes, card):
    """Phase 11: the integrator at full width (jacobian='dd': K4 once per
    loop iteration), its profiler split, 'dd' against 'xla' on slices,
    and the fuse_gather=False flagship path timed."""
    res = {'ms': {}}
    B = sizes['integrate']
    y, P = flagship_states(B)
    y0 = torch.as_tensor(y, device=device)
    P0 = torch.as_tensor(P, device=device)
    out = {}

    def run():
        out['r'] = integrate(packed, y0, P0, T_END, jacobian='dd',
                             method='ros23')

    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    wall = best_ms(run, reps=3, warm=1)
    counts = dict(kernels.launches)
    r = out['r']
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    summ, hist = integrate_summary(r)
    print('phase 11a integrate: B=%d, t_end %g s, ROS23, jacobian=dd, best '
          'of 3 %.3f ms = %.0f states/s, %s, peak %.2f GiB, launches %s (%s)'
          % (B, T_END, wall, B / (wall * 1e-3), summ, peak, counts, card))
    check(bool(torch.isfinite(r.y).all()), 'non-finite integrated states')
    check(hist == {STATUS_SUCCESS: B}, 'not every state succeeded: %s' % hist)
    check(counts['dense_fused'] == 4 * r.iterations,
          'K4 launches %d != 4 runs x %d iterations' % (
              counts['dense_fused'], r.iterations))
    res.update(counts_integrate=counts, wall=wall, iterations=r.iterations)
    res['split'] = integrate_profile(run, r.iterations, card)

    # K4 alone at this shape, beside its plain version and its bound
    dj = DenseJacobian(packed, device=device)
    y_t, P_t = y0.T.contiguous(), P0[None].contiguous()
    res['ms']['dense_fused'] = per_call_ms(lambda: dj.call_tr(y_t, P_t))
    res['ms']['dense_fused_plain'] = best_ms(
        lambda: dense_reference(packed, y_t, P_t, True), reps=2)
    Jt, f = dj.call_tr(y_t, P_t)
    tabs = [v for k, v in dj._buffers.items() if k.startswith(('kp_', 'kf_'))]
    ops = dense_ops(dj, B)
    res['bound'] = bound(nbytes(y_t, P_t, Jt, f, *tabs), ops)
    print('  dense_fused: kernel %.3f ms, plain version %.3f ms, library call '
          'none, bound %.3f ms (%s; %.4e operations: %.3f ms at %.0e/s) '
          '(flagship, B=%d, %s, %s)' % (
              res['ms']['dense_fused'], res['ms']['dense_fused_plain'],
              res['bound'][0], res['bound'][1], ops, ops / F64_FLOP_S * 1e3,
              F64_FLOP_S, B, plan_tag(card_plan(dj, F64, B)), card))
    del Jt, f, dj, out
    torch.cuda.empty_cache()

    # 'dd' against 'xla' on slices: the PaSR states, both methods, and the
    # states heated by 300 K (hundreds of steps, with rejections)
    Bs = sizes['integrate_check']
    t0 = time.perf_counter()
    for method in ('ros23', 'rodas3'):
        a = integrate(packed, y0[:Bs], P0[:Bs], T_END, jacobian='dd',
                      method=method)
        b = integrate(packed, y0[:Bs], P0[:Bs], T_END, jacobian='xla',
                      method=method)
        err = same_run(a, b, method)
        print('phase 11b %s dd vs xla: B=%d, %s; same steps, endpoints '
              'floored@1e-10 %.3e (<= %.0e) (%.1f s, %s)' % (
                  method, Bs, integrate_summary(a)[0], err, TOL_INTEGRATE,
                  time.perf_counter() - t0, card))
        t0 = time.perf_counter()
    Bh = sizes['integrate_hot']
    yh = y0[:Bh].clone()
    yh[:, 0] += 300.0
    a = integrate(packed, yh, P0[:Bh], T_END, jacobian='dd')
    b = integrate(packed, yh, P0[:Bh], T_END, jacobian='xla')
    err = same_run(a, b, 'ros23 +300 K')
    check(int(a.rejected.sum()) > 0, '+300 K states rejected no step')
    print('phase 11c ros23 +300 K dd vs xla: B=%d, %s; same steps, endpoints '
          'floored@1e-10 %.3e (<= %.0e) (%.1f s, %s)' % (
              Bh, integrate_summary(a)[0], err, TOL_INTEGRATE,
              time.perf_counter() - t0, card))
    del a, b, yh
    torch.cuda.empty_cache()

    # --- d. the fuse_gather=False flagship path, timed as phase 5 --------
    Bx = sizes['unfused']
    sx = SparseJacobian(packed, fuse_gather=False, device=device)
    yx, Px = to_tr(*flagship_states(Bx), device)
    ms, cx, chk = timed_path(sx, yx, Px, ('stage_a', 'stage_b_x'))
    check(cx['stage_b'] == 0, 'the unfused path launched K2')
    res['counts_unfused'] = cx
    print('phase 11d flagship fuse_gather=False path: B=%d, best of 3 %.3f ms '
          '= %.0f evals/s, checksums %s, launches %s (%s)' % (
              Bx, ms, Bx / (ms * 1e-3), ['%.6e' % c for c in chk], cx, card))
    a = sx.stage_a(yx, Px)
    p1 = sx.stage_gather(a['src'])
    rows = torch.arange(sx.J * sx.Rmax, device=device).view(sx.J, sx.Rmax)
    k = res['ms']
    k['stage_gather'] = best_ms(lambda: sx.stage_gather(a['src']))
    k['stage_b_x'] = best_ms(lambda: sx.stage_b_x(p1, a['post']))
    k['stage_b_x_plain'] = best_ms(
        lambda: stage_b_reference(rows, sx.nuc, sx.inv_mw, p1, a['post']),
        reps=2)
    k['stage_b_x_lib'] = best_ms(
        lambda: torch.bmm(sx.nuc, p1.view(sx.J, sx.Rmax, Bx)))
    res['bound_x'] = bound(nbytes(p1, a['post'], sx.kx_ptr, sx.kx_src,
                                  sx.kx_coef, sx.inv_mw) +
                           8 * sx.J * sx.N * Bx,
                           2 * sx.kx_coef.numel() * Bx + 8 * sx.J * sx.N * Bx)
    print('  stage_b_x (K2x): kernel %.3f ms, plain version %.3f ms, library '
          'call %.3f ms, bound %.3f ms (%s); the gather alone %.3f ms '
          '(B=%d, %s)' % (k['stage_b_x'], k['stage_b_x_plain'],
                          k['stage_b_x_lib'], res['bound_x'][0],
                          res['bound_x'][1], k['stage_gather'], Bx, card))
    return res


# ---------------------------------------------------------------------------
# the float32 fused kernel K3 and the port's bench
# ---------------------------------------------------------------------------


def cuobjdump():
    """The CUDA toolkit's ``cuobjdump`` (or Triton's copy of it)."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, 'bin', 'cuobjdump')] if CUDA_HOME else []
    cands.append(shutil.which('cuobjdump') or '')
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), 'backends',
                                  'nvidia', 'bin', 'cuobjdump'))
    except ImportError:
        pass
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise Fail('cuobjdump not found: cannot check K3 for float64 SASS')


def start_sass_dump(library):
    """Start ``cuobjdump -sass`` of the built library in the background
    (it takes seconds); :func:`f64_sass_counts` reads its output."""
    path = library + '.sass.txt'
    with open(path, 'w') as fh:
        proc = subprocess.Popen([cuobjdump(), '-sass', library], stdout=fh,
                                stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc, path


def f64_sass_counts(library, dump=None):
    """{kernel function: number of float64 SASS instructions} of every
    function in the built library (``cuobjdump -sass``; ``dump``: a
    :func:`start_sass_dump` of it)."""
    proc, path = dump or start_sass_dump(library)
    err = proc.communicate(timeout=300)[1]
    check(proc.returncode == 0, 'cuobjdump failed: %s' % err[-2000:])
    with open(path) as fh:
        text = fh.read()
    os.unlink(path)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            counts[name] = 0
            continue
        m = re.search(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)',
                      line)
        if name and m and F64_SASS_OP.match(m.group(1)):
            counts[name] += 1
    return counts


def phase_sass_f64(dump):
    """Phase 2b: K3 (``dense_fused_kernel<float, ...>``) holds no float64
    instruction; K4's (``<double, ...>``) count shows that the scan sees
    them.  ``dump``: the :func:`start_sass_dump` of phase 2."""
    t0 = time.perf_counter()
    counts = f64_sass_counts(kernels.build_info['library'], dump)
    waited = time.perf_counter() - t0
    k3 = {n: c for n, c in counts.items() if 'dense_fused_kernelIf' in n}
    k4 = {n: c for n, c in counts.items() if 'dense_fused_kernelId' in n}
    print('phase 2b SASS float64 instructions: K3 (float) %s, K4 (double) '
          '%s (waited %.1f s for the dump)' % (
              sorted(k3.values()), sorted(k4.values()), waited))
    check(len(k3) == 8 and len(k4) == 8,
          'dense_fused_kernel instantiations not found: %s' % sorted(counts))
    check(all(c == 0 for c in k3.values()),
          'K3 holds float64 SASS instructions: %s' % k3)
    check(all(c > 0 for c in k4.values()), 'the float64 scan found nothing '
          'in K4: %s' % k4)
    return sum(k3.values())


def f32_err(a, b):
    """The JAX package's f32 metric on two float32 arrays of the same
    shape: (share of entries finite in both, max |a - b| over those /
    max |b| over those, max |a - b| over those)."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    share = float(fin.sum()) / fin.numel()
    diff = float(torch.where(fin, a - b, 0.0).abs().max())
    scale = float(torch.where(fin, b, 0.0).abs().max())
    return share, diff / max(scale, 1e-30), diff


def f32_states(packed, B, device):
    """The f32 cell's states (the JAX bench's draw): float32 (N, B) and
    (1, B), and the float64 (B, N), (B,) they were rounded from."""
    y, _, P = random_states(packed.mech, B, seed=1, T_range=(1500.0, 2500.0))
    return (torch.as_tensor(y.T.copy(), dtype=torch.float32, device=device),
            torch.as_tensor(P[None].copy(), dtype=torch.float32,
                            device=device))


def gate_f32(tag, errs):
    for nm, (share, err) in errs.items():
        print('  %s %-2s finite share %.6f (>= %.3f), max |diff| / scale '
              '%.3e (< %.0e)' % (tag, nm, share, F32_FINITE, err, TOL_F32))
    for nm, (share, err) in errs.items():
        check(share >= F32_FINITE and err < TOL_F32,
              '%s %s: finite share %.6f, error %.3e' % (tag, nm, share, err))


def finite_pair(a, b):
    """float64 copies of ``a`` and ``b``, 0 on both where either is not
    finite."""
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (torch.where(fin, a.double(), 0.0),
            torch.where(fin, b.double(), 0.0))


def f32_gross(packed, y_t, param, conp, chunk=32768):
    """:func:`dense_t_gross` of float32 states, ``chunk`` states at a
    time."""
    return torch.cat([dense_t_gross(packed, y_t[:, s:s + chunk].double(),
                                    param[:, s:s + chunk].double(), conp)
                      for s in range(0, y_t.shape[-1], chunk)], 1)


def f32_own_errs(got, gf, ref, rf, gross, chunk=32768):
    """Phase 9a's gates for K3's (J, f) against its plain version's, on
    the entries finite on both sides, each state on its own scales: col0
    and f as phase 9a; J's species rows (columns 1..J) floored at
    ``F32_FLOOR`` x the state's largest species-row entry there; J's
    temperature row (columns 1..J) on ``gross`` (:func:`f32_gross`).
    {gate: (reading, limit)}."""
    c0g, c0r = finite_pair(got[0], ref[0])
    fg, fr = finite_pair(gf, rf)
    errs = {'col0 T': (row_rel(c0g[:1], c0r[:1]), TOL_F32_NET),
            'col0 Y': (state_rel(c0g[1:], c0r[1:]), TOL_F32_NET),
            'f T': (row_rel(fg[:1], fr[:1]), TOL_F32_NET),
            'f Y': (state_rel(fg[1:], fr[1:]), TOL_F32_NET),
            'f Y per row': (row_rel(fg[1:], fr[1:]), TOL_F32_NET)}
    jy = jt = 0.0
    for s in range(0, got.shape[-1], chunk):
        g, r = finite_pair(got[1:, 1:, s:s + chunk], ref[1:, 1:, s:s + chunk])
        jy = max(jy, floored(g, r, F32_FLOOR))
        g, r = finite_pair(got[1:, 0, s:s + chunk], ref[1:, 0, s:s + chunk])
        jt = max(jt, float(((g - r).abs() / gross[:, s:s + chunk]).max()))
    errs['J Y'] = (jy, TOL_F32_JY)
    errs['J T'] = (jt, TOL_F32_JT)
    return errs


def f32_scale_shares(ref):
    """On every 64th state of the plain version's J: the median |entry| /
    the JAX metric's scale, and the share of entries above TOL_F32 x that
    scale, for the species rows and the temperature row."""
    scale = float(torch.where(torch.isfinite(ref), ref, 0.0).abs().max())
    out = {}
    for nm, part in (('J Y', ref[:, 1:, ::64]), ('J T', ref[:, 0, ::64])):
        a = part.double().abs()[torch.isfinite(part)] / scale
        out[nm] = (float(a.median()), float((a > TOL_F32).double().mean()))
    return out


def planted_faults(got, gf, ref, rf, gross, tag):
    """Phase 12's gates on K3's outputs with a planted fault: J's species
    rows (columns 1..J) scaled by 1 + F32_FAULT, then its temperature row
    (columns 1..J); each must fail its own-scale gate.  The JAX metric's
    reading of each is printed."""
    for nm, rows in (('J Y', slice(1, None)), ('J T', slice(0, 1))):
        bad = got.clone()
        bad[1:, rows] *= 1.0 + F32_FAULT
        own = f32_own_errs(bad, gf, ref, rf, gross)[nm]
        jax = f32_err(bad, ref)[1]
        del bad
        print('  %s fault %s x (1 + %.0e): own-scale %s %.3e (limit %.0e), '
              'JAX metric %.3e (limit %.0e)' % (tag, nm, F32_FAULT, nm, own[0],
                                               own[1], jax, TOL_F32))
        check(own[0] > own[1], 'the %s gate missed a planted fault' % nm)


def phase_f32_kernels(cases, device, card):
    """Phase 12: K3 against ``f32_reference`` on the same float32 inputs,
    CONP and CONV, by the JAX metric and on each state's own scales
    (:func:`f32_own_errs`; on the main case also :func:`planted_faults`);
    K3 against the float64 ``SparseJacobian``; the flagship
    golden through ``F32Jacobian``.  The case marked ``main`` gives the
    row's ``max_abs_err`` (CONP, J and f, finite entries)."""
    check(torch.backends.cuda.matmul.allow_tf32 is False and
          torch.get_float32_matmul_precision() == 'highest',
          'float32 matmuls would run in TF32')
    res = {}
    for name, packed, B, main, placement in cases:
        if name == 'flagship':
            y_t, P_t = f32_states(packed, B, device)
        else:
            y_t, P_t = (x.float() for x in big_states(packed, B, device))
        for conp in (True, False):
            param = P_t if conp else own_density(
                packed, y_t.double(), P_t.double()).float()
            fj = F32Jacobian(packed, conp=conp, device=device)
            plan = card_plan(fj, torch.float32, B, placement)
            got, gf = kernels.fused_f32(fj, y_t, param, plan=plan)
            del fj
            ref, rf = f32_reference(packed, y_t, param, conp)
            torch.cuda.synchronize()
            eJ, ef = f32_err(got, ref), f32_err(gf, rf)
            tag = 'K3 %s %s B=%d (%s)' % (name, 'conp' if conp else 'conv',
                                          B, plan_tag(plan))
            gate_f32(tag, {'J': eJ[:2], 'f': ef[:2]})
            gross = f32_gross(packed, y_t, param, conp)
            errs = f32_own_errs(got, gf, ref, rf, gross)
            for nm, (err, tol) in errs.items():
                print('  %s %-11s %.3e (<= %.0e)' % (tag, nm, err, tol))
            for nm, (err, tol) in errs.items():
                check(err <= tol, '%s %s: %.3e > %.0e' % (tag, nm, err, tol))
            if conp and main:
                res['fused_f32'] = max(eJ[2], ef[2])
                print('  %s median |J| / the JAX metric\'s scale, share above '
                      '%.0e of it: %s' % (tag, TOL_F32, ', '.join(
                          '%s %.3e, %.4f' % (nm, *v)
                          for nm, v in f32_scale_shares(ref).items())))
                planted_faults(got, gf, ref, rf, gross, tag)
            del got, gf, ref, rf, gross
            torch.cuda.empty_cache()
        if name == 'flagship' and main:
            # the float64 sparse pipeline on the same (f32-rounded) states
            Bs = min(B, 65536)
            ys, Ps = y_t[:, :Bs].contiguous(), P_t[:, :Bs].contiguous()
            got, gf = F32Jacobian(packed, device=device).call_tr(ys, Ps)
            cols, col0, f64 = SparseJacobian(packed, device=device).call_tr(
                ys.double(), Ps.double())
            J64 = full_J(cols, col0)
            del cols
            gate_f32('K3 vs SparseJacobian (f64) flagship B=%d' % Bs,
                     {'J': f32_err(got.double(), J64)[:2],
                      'f': f32_err(gf.double(), f64)[:2]})
            del got, gf, J64, f64
            torch.cuda.empty_cache()
    # the flagship golden: J at the f32 metric; dy/dt (PaSR states near
    # equilibrium cancel beyond float32) at twice the JAX kernel's reading
    packed = cases[0][1]
    g = np.load(os.path.join(DATA, 'golden_flagship_refc.npz'))
    fj = F32Jacobian(packed, device=device)
    J, f = fj(g['y'], g['P'])
    n = len(g['T'])
    Jl = J.transpose(1, 2).reshape(n, -1).double()
    ref = torch.as_tensor(g['ref_jac'], device=device)
    fr = torch.as_tensor(g['ref_dydt'], device=device)
    eJ = f32_err(Jl, ref)
    ef = f32_err(f.double(), fr)
    nrel = float(((f.double() - fr).abs().amax(1) / fr.abs().amax(1)).max())
    print('phase 12 golden flagship (F32Jacobian): J finite share %.6f, max '
          '|diff| / scale %.3e (< %.0e); dy/dt finite share %.6f, max |diff| '
          '/ scale %.3e (< %.2f), norm-rel per state %.3e (%s)' % (
              eJ[0], eJ[1], TOL_F32, ef[0], ef[1], TOL_F32_GOLDEN_F, nrel,
              card))
    check(eJ[0] >= F32_FINITE and eJ[1] < TOL_F32,
          'golden through F32Jacobian: J %s' % (eJ[:2],))
    check(ef[0] >= F32_FINITE and ef[1] < TOL_F32_GOLDEN_F,
          'golden through F32Jacobian: dy/dt %s' % (ef[:2],))
    print('phase 12 K3 vs plain: ok (%s)' % card)
    return res


def phase_f32_main(packed, device, B, card):
    """Phase 13: the f32 cell at B through ``F32Jacobian.call_tr`` (one
    warm-up, best of 3 CUDA event passes, a ``torch.sum`` of every output
    inside the pass, the launch counter), its profiler split, then K3
    alone beside its plain version and its bound."""
    y_t, P_t = f32_states(packed, B, device)
    fj = F32Jacobian(packed, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    ms, counts, chk = timed_path(fj, y_t, P_t, ('fused_f32',))
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    print('phase 13 f32 cell: B=%d, best of 3 %.3f ms = %.0f evals/s, '
          'checksums %s, peak %.2f GiB, launches %s (%s)' % (
              B, ms, B / (ms * 1e-3), ['%.6e' % c for c in chk], peak, counts,
              card))
    print_profile('f32 cell', lambda: [torch.sum(x)
                                       for x in fj.call_tr(y_t, P_t)], card,
                  split=(('K3', 'dense_fused_kernel'),),
                  rest='checksum reductions',
                  need={'dense_fused_kernel': 3})
    res = {'counts': counts, 'total_ms': ms, 'ms': {}}
    res['ms']['fused_f32'] = per_call_ms(lambda: fj.call_tr(y_t, P_t), n=5)
    res['ms']['fused_f32_plain'] = best_ms(
        lambda: f32_reference(packed, y_t, P_t, True), reps=2)
    Jt, f = fj.call_tr(y_t, P_t)
    tabs = [v for k, v in fj._buffers.items() if k.startswith(('kp_', 'kf_'))]
    ops = dense_ops(fj, B)
    res['bound'] = bound(nbytes(y_t, P_t, Jt, f, *tabs), ops, F32_FLOP_S)
    print('  fused_f32: kernel %.3f ms, plain version %.3f ms, library call '
          'none, bound %.3f ms (%s; %.4e operations: %.3f ms at %.0e/s) '
          '(flagship, B=%d, %s, %s)' % (
              res['ms']['fused_f32'], res['ms']['fused_f32_plain'],
              res['bound'][0], res['bound'][1], ops, ops / F32_FLOP_S * 1e3,
              F32_FLOP_S, B, plan_tag(card_plan(fj, torch.float32, B)),
              card))
    del Jt, f, fj, y_t, P_t
    torch.cuda.empty_cache()
    return res


def phase_bench(device, card):
    """Phase 14: the port's bench at its sizes; its JSON line."""
    res = bench.run(device=device, log=sys.stdout)
    st = res['detail']['stats_1m']
    print('phase 14 bench 1M cell: %d states in %d chunks of %d (%s), '
          'staging %.4f s (%.0f MB at %.1f MB/s host->device), compute %.4f s '
          '= %.0f evals/s, passes %s s (%s)' % (
              st['states'], st['n_chunks'], st['chunk_b'], st['kernel'],
              st['staging_s'], st['staging_bytes'] / 1e6, st['staging_mb_s'],
              st['compute_s'], st['evals_per_s'],
              ['%.4f' % t for t in st['pass_s']], card))
    line = {k: v for k, v in res.items() if k != 'detail'}
    print(json.dumps(line))
    check(all(math.isfinite(line[k]) and line[k] > 0 for k in (
        'value', 'value_1m_chunked')), 'bench: %s' % line)
    return res


# ---------------------------------------------------------------------------
# the user front end: the performance tester, the functional tester, the
# CLI and the PaSR generator
# ---------------------------------------------------------------------------

def write_mech_dir(work, name, text, states):
    """``work/name/name.inp`` and ``work/name/states.npy`` (rows of
    (t, T, P, Y in the mechanism's original species order))."""
    d = os.path.join(work, name)
    os.makedirs(d)
    path = os.path.join(d, name + '.inp')
    with open(path, 'w') as fh:
        fh.write(text)
    np.save(os.path.join(d, 'states.npy'), states)
    return path


def state_rows(mech, y, P):
    """(t, T, P, Y original order) rows of pivoted states ``y``, as
    ``testers/__main__.py`` builds them."""
    Y_full = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)],
                            axis=1)
    return np.concatenate([np.zeros((len(y), 1)), y[:, :1], P[:, None],
                           Y_full[:, np.asarray(mech.back_spec_mapping)]], 1)


def sweep(work, runs, repeats, device):
    """One ``performance_tester`` call per (method, steps), each with
    the launch counters set to 0 just before and read just after."""
    counts = {}
    for method, steps in runs:
        kernels.reset_launches()
        performance_tester(work, methods=[method], repeats=repeats,
                           steps=steps, verbose=False, device=device)
        counts[method] = dict(kernels.launches)
    return counts


def sweep_file(work, name, method):
    """The tester's output file of ``method`` at mechanism ``name``,
    named by the precision the method computes in."""
    return os.path.join(work, 'output', PerfConfig(
        name, method, method_precision(method), 0).filename)


def read_sweep(work, name, method):
    """{num_odes: best ms} of one output file."""
    best = {}
    with open(sweep_file(work, name, method)) as fh:
        for line in fh:
            n, ms = line.split(',')
            best[int(n)] = min(best.get(int(n), math.inf), float(ms))
    return best


def file_lines(work):
    out = {}
    for fn in sorted(os.listdir(os.path.join(work, 'output'))):
        with open(os.path.join(work, 'output', fn)) as fh:
            out[fn] = fh.read()
    return out


def phase_pasr(device, card):
    """Phase 15e: a short PaSR run on the card, the chemistry through the
    port's integrator (``n_part * N > 1024``)."""
    t0 = time.perf_counter()
    mech, packed = packed_from_text(plausible_mechanism(*PASR_MECH, seed=5))
    N = packed.n_species
    check(PASR_PARTICLES * N > 1024, 'PaSR size would take scipy BDF')
    names = list(mech.species_names)
    rng = np.random.default_rng(7)
    X = np.zeros(N)
    for i in [i for i, nm in enumerate(names) if nm != 'N2'][:6]:
        X[i] = rng.uniform(0.05, 0.15)
    X[names.index('N2')] = 1.0 - X.sum()
    X /= X.sum()
    Y = pasr.mole_to_mass_fracs(packed, X)
    fw = np.asarray(mech.fwd_spec_mapping)
    # the pilot (1900 K, relaxed onto the kinetic manifold) and the inlet
    # (1000 K, its fastest modes damped) in one batch, each over its own
    # horizon, with K4's stage Jacobian
    y0 = np.stack([np.concatenate([[T], Y[fw][:-1]]) for T in (1900., 1000.)])
    r = integrate(packed, torch.as_tensor(y0, device=device),
                  torch.full((2,), PASR_P_ATM * 101325.0, dtype=F64,
                             device=device),
                  torch.as_tensor(PASR_RELAX, device=device), rtol=1e-3,
                  atol=1e-12, max_steps=20000, jacobian='dd', device=device)
    check(bool((r.status == STATUS_SUCCESS).all()),
          'PaSR stream relaxation failed: %s' % r.status.tolist())
    y1 = r.y.cpu().numpy()
    Y_pilot = np.concatenate([y1[0, 1:], [1.0 - y1[0, 1:].sum()]])
    Y_in = np.concatenate([y1[1, 1:], [1.0 - y1[1, 1:].sum()]])
    X_in = Y_in * np.asarray(packed.inv_mw)
    t1 = time.perf_counter()
    data = pasr.run_simulation(
        mech, 'premixed', init_temp=float(y1[1, 0]), pres=PASR_P_ATM,
        eq_ratio=1.0,
        fuel={}, oxidizer={}, num_part=PASR_PARTICLES, tau_res=PASR_TAU_RES,
        tau_mix=1e-3, tau_pair=1e-3, num_res=1, seed=3, verbose=False,
        inlet_X=X_in / X_in.sum(), pilot=(float(y1[0, 0]), Y_pilot),
        chem_tols=PASR_TOLS, device=device)
    T = data[..., 1]
    lo = min(sp.Trange[0] for sp in mech.specs)
    hi = max(sp.Trange[2] for sp in mech.specs)
    print('phase 15e PaSR: %d species / %d reactions, %d particles, %d '
          'frames (%s), T %.1f..%.1f K (thermo %.0f..%.0f K); streams '
          'relaxed in %d iterations, %.1f s; run %.1f s (%s)' % (
              N, packed.n_reactions, PASR_PARTICLES, data.shape[0],
              data.shape, T.min(), T.max(), lo, hi, r.iterations, t1 - t0,
              time.perf_counter() - t1, card))
    check(np.isfinite(data).all(), 'non-finite PaSR particles')
    check(bool(((T >= lo) & (T <= hi)).all()),
          'PaSR temperature outside the thermo range')


def phase_frontend(mech, device, card, main_res, f32, integ):
    """Phase 15: the user entry points on the card, in a work directory
    under the build directory."""
    work = str(kernels.build_dir() / 'frontend')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    d = np.load(os.path.join(DATA, 'flagship_states.npz'))
    inp = write_mech_dir(work, 'flagship',
                         plausible_mechanism(53, 325, seed=42),
                         state_rows(mech, d['y'], d['P']))
    flag_states = os.path.join(work, 'flagship', 'states.npy')

    # b. the sweep: the flagship first, then the USC-II class beside it
    # (its calls resume the flagship's files: those sizes are done)
    t0 = time.perf_counter()
    runs, usc_runs = FRONT_RUNS, USC_RUNS
    counts = sweep(work, runs, FRONT_REPEATS, device)
    usc_text = plausible_mechanism(111, 784, seed=5)
    usc_mech, _ = packed_from_text(usc_text)
    y, T, P = random_states(usc_mech, 4096, seed=3)
    write_mech_dir(work, 'usc', usc_text, state_rows(usc_mech, y, P))
    usc_counts = sweep(work, usc_runs, FRONT_REPEATS, device)
    for method, c in usc_counts.items():
        counts[method] = {k: counts[method][k] + v for k, v in c.items()}
    only = {'dd-sparse': ('stage_a', 'stage_b'), 'dd': ('dense_fused',),
            'pallas': ('fused_f32',)}
    for method, _ in runs:
        want = only.get(method, ())
        check(all(counts[method][k] > 0 for k in want) and
              not any(v for k, v in counts[method].items() if k not in want),
              'tester %s launched %s (want only %s)' % (
                  method, counts[method], want))
    for name, rr in (('flagship', runs), ('usc', usc_runs)):
        for method, steps in rr:
            fn = sweep_file(work, name, method)
            got = check_step_file(fn, FRONT_REPEATS)
            check(got == {n: FRONT_REPEATS for n in steps},
                  '%s: lines per size %s' % (fn, got))
    # the USC-II calls again: every size of both mechanisms' files is done
    before = file_lines(work)
    again = sweep(work, usc_runs, FRONT_REPEATS, device)
    check(file_lines(work) == before, 'the resumed sweep appended lines')
    check(not any(v for c in again.values() for v in c.values()),
          'the resumed sweep launched kernels: %s' % again)
    sweep_s = time.perf_counter() - t0
    res = {'counts': counts, 'best': {}}
    for name, rr in (('flagship', runs), ('usc', usc_runs)):
        for method, _ in rr:
            best = read_sweep(work, name, method)
            res['best'][name, method] = best
            print('phase 15b sweep %s %s: %s (%s)' % (
                name, method, ', '.join(
                    '%d odes %.3f ms = %.0f evals/s' % (n, ms, n / ms * 1e3)
                    for n, ms in sorted(best.items())), card))
    ratios = (
        ('dd-sparse', 131072, main_res['total_ms'], 'phase 5 pass'),
        ('pallas', 262144, f32['total_ms'], 'phase 13 pass'),
        ('dd', 32768, integ['ms']['dense_fused'], 'phase 11 K4 alone'))
    for method, n, ref, what in ratios:
        ms = res['best']['flagship', method][n]
        res['ratio_' + method] = ms / ref
        print('  tester %s at B=%d: %.3f ms against %s %.3f ms: ratio %.3f '
              '(%s)' % (method, n, ms, what, ref, ms / ref, card))
    print('phase 15b sweep: %.1f s, launches %s, resumed call appended '
          'nothing (%s)' % (sweep_s, counts, card))

    # c. the functional tester on 64 flagship PaSR states
    t0 = time.perf_counter()
    err_path = os.path.join(work, 'error_arrays.npz')
    rc = testers_main(['-i', inp, '-d', flag_states, '-n', '64',
                       '--fail-above', repr(TOL_FUNCTIONAL), '-o', err_path,
                       '--device', device.type])
    e = np.load(err_path)
    res['functional'] = {k: float(e[k].max()) for k in e.files}
    print('phase 15c functional tester: 64 flagship PaSR states, worst '
          'state (the JAX package on the CPU): %s; gate %.3e on '
          'err_jac_thr_max, rc %d (%.1f s, %s)' % (
              ', '.join('%s %.3e (%.3e)' % (k, res['functional'][k], v)
                        for k, v in FUNCTIONAL_JAX_CPU.items()),
              TOL_FUNCTIONAL, rc, time.perf_counter() - t0, card))
    check(rc == 0, 'functional tester failed its gate')

    # d. the CLI: archive, manifest, --validate CONP and CONV, -ic
    t0 = time.perf_counter()
    out = os.path.join(work, 'cli')
    for extra in ([], ['--conv']):
        rc = cli.main(['-i', inp, '-b', out, '--validate', '--states', '64',
                       '--device', device.type] + extra)
        check(rc == 0, 'CLI --validate %s failed' % extra)
    names = mech.species_names
    ic = '1200,10,%s=0.79,%s=0.2,%s=0.01' % (names[-1], names[0], names[1])
    check(cli.main(['-i', inp, '-b', out, '-ic', ic]) == 0, 'CLI -ic failed')
    s0 = np.load(os.path.join(out, 'initial_state.npy'))
    check(s0.shape == (mech.n_species + 1,) and np.isfinite(s0).all(),
          'initial_state.npy: %s' % (s0,))
    print('phase 15d CLI: archive, manifest, --validate CONP and CONV on 64 '
          'states (<= 1e-8), -ic %s -> initial_state.npy (%.1f s, %s)' % (
              ic, time.perf_counter() - t0, card))

    # e. a short PaSR run
    phase_pasr(device, card)
    return res


def kernel_rows(errs, main_res, synth, big, integ, f32, front):
    """The kernels line: one row per ported TPU kernel.  ``launches`` is
    the count of the path at whose shape the kernel is timed;
    ``launches_by_path`` every path's run, the performance tester's
    kernel methods included."""
    flag = {'flagship': main_res['counts'],
            'flagship_unfused': integ['counts_unfused'],
            'synth53': synth['counts'],
            'synth53_unfused': synth['counts_unfused']}
    rows = []
    for name, src, line in (
            ('stage_a', 'sparse_stage_a.cu', 'pallas_dd.py:2099'),
            ('stage_b', 'sparse_stage_b.cu', 'pallas_dd.py:2204'),
            ('stage_b_x', 'big_cols_sparse.cu', 'pallas_dd.py:2162'),
            ('dense_fused', 'dense_fused.cu', 'pallas_dd.py:2017'),
            ('big_parts', 'big_parts.cu', 'pallas_dd.py:2747'),
            ('big_cols_sparse', 'big_cols_sparse.cu', 'pallas_dd.py:2785'),
            ('big_cols_dense', 'big_cols_dense.cu', 'pallas_dd.py:2669'),
            ('fused_f32', 'dense_fused.cu', 'pallas_jacobian.py:310')):
        if name in ('stage_a', 'stage_b', 'stage_b_x'):
            ms = main_res['ms'] if name != 'stage_b_x' else integ['ms']
            by_path = {p: c[name] for p, c in flag.items()}
            main_path = ('flagship_unfused' if name == 'stage_b_x'
                         else 'flagship')
            b_ms, b_by = (integ['bound_x'] if name == 'stage_b_x'
                          else main_res['bounds'][name])
        elif name == 'dense_fused':
            ms, main_path = integ['ms'], 'integrate'
            by_path = {'integrate': integ['counts_integrate'][name]}
            b_ms, b_by = integ['bound']
        elif name == 'fused_f32':
            ms, main_path = f32['ms'], 'f32'
            by_path = {'f32': f32['counts'][name]}
            b_ms, b_by = f32['bound']
        else:
            ms = big['ms']
            by_path = {p: big['counts_' + p][name]
                       for p in ('654', 'usc', '654_dense')}
            main_path = '654_dense' if name == 'big_cols_dense' else '654'
            b_ms, b_by = big['bounds'][name]
        for method in ('dd-sparse', 'dd', 'pallas'):
            by_path['perf_' + method.replace('-', '_')] = \
                front['counts'][method][name]
        rows.append(dict(
            name=name, route='cuda', source='pyjac_tpu_torch/csrc/' + src,
            replaces='pyjac_tpu/ops/' + line, launches=by_path[main_path],
            max_abs_err=errs[name], ms=ms[name], plain_ms=ms[name + '_plain'],
            bound_ms=b_ms, bound_by=b_by, library_ms=ms.get(name + '_lib'),
            launches_by_path=by_path))
    return rows


def main():
    t0 = time.perf_counter()
    # --- phase 1: device -----------------------------------------------------
    check(torch.cuda.is_available(), 'no CUDA device available')
    device = torch.device('cuda', 0)
    card = smi_line()
    print('phase 1 device: %s; torch %s, CUDA %s' % (
        card, torch.__version__, torch.version.cuda))
    # --- phase 2: build ------------------------------------------------------
    kernels.load()
    print('phase 2 build: %.1f s -> %s' % (
        kernels.build_info['seconds'], kernels.build_info['library']))
    for line in kernels.build_info['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas: ' + line.strip())
    sass_dump = start_sass_dump(kernels.build_info['library'])

    mech, packed = flagship()
    p_syn = packed_from_text(synthetic_mechanism(9, 24, seed=7))[1]
    p_syn53 = packed_from_text(synthetic_mechanism(53, 325, seed=7))[1]
    p654 = packed_from_text(plausible_mechanism(654, 2716, seed=5))[1]
    p_usc = packed_from_text(plausible_mechanism(111, 784, seed=5))[1]
    # batch of each phase-8 path; phase 6 checks the kernels at each
    sizes = {'654': 1024, 'usc': 32768, '654_dense': 512}
    # phases 3, 9a and 12 also hold K1 + K2, K4 and K3 at the performance
    # tester's largest batches (phase 15b), where their cases lack them
    tester_mechs = {'flagship': packed, 'usc': p_usc}
    errs = phase_kernels_vs_plain(with_tester_shapes(
        (('flagship', packed, 16384, True),
         ('synth53', p_syn53, 16384, False)), 'dd-sparse', tester_mechs,
        (False,)), device, card)
    # K1's other cases: a ragged batch under the planner's tile and under
    # the global placement; USC-II (4 states a tile); the 654 class (one
    # state a tile) and, ragged, under the global placement
    phase_stage_a_tiles((('flagship', packed, 4099, None),
                         ('flagship', packed, 4099, 'global'),
                         ('usc', p_usc, 4096, None),
                         ('654', p654, 128, None),
                         ('654', p654, 127, 'global')), device, card)
    phase_golden((('flagship', packed), ('synth', p_syn)), device, card)
    sj = SparseJacobian(packed, device=device)
    main_res = phase_main(sj, packed, device, 131072, card)
    del sj
    torch.cuda.empty_cache()
    synth = phase_synth_main(p_syn53, device, 131072, card)
    phase_stage_a_usc(p_usc, device, sizes['usc'], card)
    phase_sass_f64(sass_dump)
    seconds = {'1-5b': time.perf_counter() - t0}

    errs.update(phase_big_kernels((
        ('654', p654, sizes['654'], ('K6',),
         ('big_parts', 'big_cols_sparse')),
        ('654', p654, sizes['654_dense'], ('K7',), ('big_cols_dense',)),
        ('usc', p_usc, sizes['usc'], ('K6',), ()),
        ('synth', p_syn, 16384, ('K6', 'K7'), ())), device, card))
    phase_big_golden((('flagship', packed), ('synth', p_syn)), device, card)
    big = phase_big_main({'654': p654, 'usc': p_usc}, sizes, device, card)
    seconds['6-8'] = time.perf_counter() - t0 - sum(seconds.values())

    # K4's cases: its timed shape; the 9/24 synth; a ragged batch under
    # the planner's tile and under the global placement; USC-II (3
    # states a tile, ragged); the 654 class (global slices)
    errs.update(phase_dense_kernels(with_tester_shapes((
        ('flagship', packed, 32768, True, None),
        ('synth', p_syn, 16384, False, None),
        ('flagship', packed, 4099, False, None),
        ('flagship', packed, 4099, False, 'global'),
        ('usc', p_usc, 4096, False, None),
        ('654', p654, 128, False, None)), 'dd', tester_mechs,
        (False, None)), device, card))
    errs.update(phase_k2x(packed, device, 131072, card))
    phase_dense_golden((('flagship', packed), ('synth', p_syn)), device, card)
    seconds['9-10'] = time.perf_counter() - t0 - sum(seconds.values())
    # phases 12-13 run before 11: after the integrate cell's long traced
    # call, a later torch.profiler session on the card records no kernels
    # (measured), and phase 13 needs one
    # K3's: its timed shape; the 9/24 synth; a ragged batch; USC-II (6
    # states a tile, ragged); the 654 class (one state a tile) and, ragged,
    # under the global placement
    errs.update(phase_f32_kernels(with_tester_shapes((
        ('flagship', packed, 262144, True, None),
        ('synth', p_syn, 16384, False, None),
        ('flagship', packed, 4099, False, None),
        ('usc', p_usc, 4096, False, None),
        ('654', p654, 128, False, None),
        ('654', p654, 127, False, 'global')), 'pallas', tester_mechs,
        (False, None)), device, card))
    f32 = phase_f32_main(packed, device, 262144, card)
    seconds['12-13'] = time.perf_counter() - t0 - sum(seconds.values())
    integ = phase_integrate(packed, device, {
        'integrate': 32768, 'integrate_check': 4096, 'integrate_hot': 256,
        'unfused': 131072}, card)
    seconds['11'] = time.perf_counter() - t0 - sum(seconds.values())
    phase_bench(device, card)
    seconds['14'] = time.perf_counter() - t0 - sum(seconds.values())
    front = phase_frontend(mech, device, card, main_res, f32, integ)
    seconds['15'] = time.perf_counter() - t0 - sum(seconds.values())
    print('phase seconds (host clock): %s, total %.1f s' % (
        ', '.join('%s %.1f' % kv for kv in seconds.items()),
        time.perf_counter() - t0))

    rows = kernel_rows(errs, main_res, synth, big, integ, f32, front)
    print(json.dumps({'kernels': rows}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except Fail as e:
        print('chip_smoke FAILED: %s' % e, file=sys.stderr)
        sys.exit(1)
    finally:
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
