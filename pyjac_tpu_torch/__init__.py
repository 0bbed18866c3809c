"""pyjac_tpu_torch — analytical-Jacobian chemical kinetics in PyTorch + CUDA.

The port of :mod:`pyjac_tpu` (JAX, Pallas kernels for the TPU) to
PyTorch and hand-written CUDA kernels for the NVIDIA H100.  It computes
in native float64, apart from the float32 throughput path
``F32Jacobian`` (kernel K3), and imports neither JAX nor
:mod:`pyjac_tpu`.

Quick start::

    import torch
    import pyjac_tpu_torch as pjt

    mech = pjt.Mechanism.from_files('mech.inp', 'therm.dat')
    packed = pjt.pack(mech)
    # y = [T, Y_1..Y_{N-1}] float64 with arbitrary leading batch dims
    f = pjt.dydt(packed, 0.0, pressure, y)            # (..., N)
    J = pjt.eval_jacobian(packed, 0.0, pressure, y)   # (..., N, N)

    # the compressed sparse pipeline and the large-mechanism pipeline;
    # they run on the CUDA card (the hand-written kernels of
    # pyjac_tpu_torch/csrc) unless device='cpu' asks for the plain
    # versions
    sj = pjt.SparseJacobian(packed)
    J, f = sj(y_batch, P_batch)                       # (B, N, N), (B, N)
    bj = pjt.BigJacobian(packed)        # K5 + K6; sparse_cols=False: K7
    J, f = bj(y_batch, P_batch)
    dj = pjt.DenseJacobian(packed)      # K4, one fused launch
    J, f = dj(y_batch, P_batch)
    fj = pjt.F32Jacobian(packed)        # K3: K4's kernel in float32
    J32, f32 = fj(y_batch, P_batch)

    # chunked evaluation of large batches (K1 + K2, or K4)
    ev = pjt.BatchEvaluator(packed)
    chk, stats = ev.jacobian_dd_resident(y_1m, P_1m, chunk_b=131072)

    # stiff integration (ROS23 / RODAS3) with the K4 stage Jacobian
    res = pjt.integrate(packed, y_batch, P_batch, 1e-4, jacobian='dd')
"""

from .core.chemkin import MechanismError, read_mech, read_thermo
from .core.ir import Reaction, Species
from .core.mech import Mechanism, get_species_mappings
from .core.pack import PackedMechanism, pack, packed_from_arrays
from .integrate import IntegrateResult, ignition_delay, integrate
from .ops.dydt import dydt, dydt_conp, dydt_conv, split_state
from .ops.jacobian import (eval_jacobian, jacobian_and_dydt, jacobian_fwd,
                           jacobian_vector_product)
from .ops.jacobian_big import BigJacobian
from .ops.jacobian_dense import DenseJacobian
from .ops.jacobian_f32 import F32Jacobian
from .ops.jacobian_sparse import SparseJacobian
from .ops.rates import (compact_pres_mod, compact_rev, eval_kc, eval_kf,
                        eval_rxn_rates, eval_spec_rates, get_rxn_pres_mod,
                        rates_of_progress, third_body_concentrations)
from .ops.thermo import (eval_conc, eval_conc_rho, eval_cp, eval_cv,
                         eval_h, eval_smh, eval_u)
from .parallel.batch import BatchEvaluator

__version__ = '0.1.0'

__all__ = [
    'BatchEvaluator', 'BigJacobian', 'DenseJacobian', 'F32Jacobian',
    'IntegrateResult', 'Mechanism',
    'MechanismError', 'PackedMechanism', 'Reaction', 'SparseJacobian',
    'Species', 'compact_pres_mod', 'compact_rev', 'dydt',
    'dydt_conp', 'dydt_conv', 'eval_conc', 'eval_conc_rho', 'eval_cp',
    'eval_cv', 'eval_h', 'eval_jacobian', 'eval_kc', 'eval_kf',
    'eval_rxn_rates', 'eval_smh', 'eval_spec_rates', 'eval_u',
    'get_rxn_pres_mod', 'get_species_mappings', 'ignition_delay',
    'integrate', 'jacobian_and_dydt',
    'jacobian_fwd', 'jacobian_vector_product', 'pack', 'packed_from_arrays',
    'rates_of_progress', 'read_mech', 'read_thermo', 'split_state',
    'third_body_concentrations',
]
