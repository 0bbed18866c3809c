"""Every port module on a mechanism wider than the CUDA kernels' slot and
Chebyshev arrays, against the JAX package, on the CPU.

``testers.synthetic.wide_mechanism`` has two reactions of 10 distinct
reactant and 10 distinct product species (fractional nu on the 2^-8
grid) and an 18 x 5 Chebyshev fit, beside PLOG, Troe, Lindemann and
third-body reactions: past the per-thread arrays of
``csrc/kinetics.cuh`` (ARRAY_SLOTS = 8, ARRAY_CHEB = 16), so on the card
the kernels K1, K4, K3 and K5 run their wide path on it.  On CPU tensors
the modules run the kernels' plain versions; these tests hold them
against the JAX package's f64 ``jacobian_and_dydt`` on the same numpy
states, CONP and CONV, with the metric of ``tests/test_golden_parity.py``
(thresholded max relative error < 1e-8, floors 1e-6 for dy/dt and 1e-10
for J); ``F32Jacobian`` against JAX's ``PallasJacobian`` (interpret) with
the JAX package's f32 metric, as ``tests/test_torch_f32.py`` holds it.
They also pin that no module refuses the mechanism on the card any more
and that the tile planner gives K1, K4 and K3 a valid plan at its width.
The wide path itself runs only on the card (``chip_smoke.py``, phase
18).
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops.jacobian import jacobian_and_dydt as jjacobian_and_dydt
from pyjac_tpu.ops.pallas_dd import PallasDDJacobianSparse
from pyjac_tpu.ops.pallas_dd import supports as jsupports
from pyjac_tpu.ops.pallas_jacobian import PallasJacobian
from pyjac_tpu_torch.core.constants import RU
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import pack
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt
from pyjac_tpu_torch.ops.jacobian_big import BigJacobian
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian, supports
from pyjac_tpu_torch.testers.synthetic import random_states, wide_mechanism

torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parent.parent / 'pyjac_tpu_torch' / \
    'csrc'
B = 64

# the f64 modules: name -> (packed, conp) -> module on the CPU
MODULES = {
    'sparse': lambda p, conp: SparseJacobian(p, conp=conp, device='cpu'),
    'sparse_unfused': lambda p, conp: SparseJacobian(
        p, conp=conp, fuse_gather=False, device='cpu'),
    'dense': lambda p, conp: DenseJacobian(p, conp=conp, device='cpu'),
    'big_sparse': lambda p, conp: BigJacobian(p, conp=conp, device='cpu'),
    'big_dense': lambda p, conp: BigJacobian(p, conp=conp,
                                             sparse_cols=False,
                                             device='cpu'),
}


def _density(p, y, P):
    """Each state's own density (CONV takes density)."""
    Yf = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)], 1)
    return P / (RU * y[:, 0] * (Yf * p.inv_mw).sum(1))


def _max_rel(test, ref, floor):
    """``tests/test_golden_parity.py``'s metric, per state."""
    test = np.asarray(test).reshape(len(ref), -1)
    ref = np.asarray(ref).reshape(len(ref), -1)
    denom = np.maximum(np.abs(ref),
                       np.abs(ref).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(test - ref) / denom).max())


def _f32_err(a, b):
    """(finite share, max |a - b| on entries finite in both / the
    largest |b| there): the JAX package's f32 metric."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    return fin.mean(), np.abs(a - b)[fin].max() / np.abs(b[fin]).max()


@pytest.fixture(scope='module')
def mech(tmp_path_factory):
    """(JAX packed, port packed, 64 states, pressures, densities), both
    packed from the same Chemkin file by each package's own parser."""
    path = tmp_path_factory.mktemp('wide') / 'wide.inp'
    path.write_text(wide_mechanism())
    jp = jpack(JMechanism.from_files(str(path)))
    p = pack(Mechanism.from_files(str(path)))
    y, _, P = random_states(p, B, seed=3)
    return jp, p, y, P, _density(p, y, P)


@pytest.fixture(scope='module')
def jax_ref(mech):
    """conp -> JAX's f64 (J, f) on the states."""
    jp, _, y, P, rho = mech
    out = {}
    for conp in (True, False):
        J, f = jjacobian_and_dydt(jp, 0.0, jnp.asarray(P if conp else rho),
                                  jnp.asarray(y), conp=conp)
        out[conp] = (np.asarray(J), np.asarray(f))
    return out


def test_mechanism_is_wider_than_the_kernel_arrays(mech):
    """10 reactant and 10 product slots, an 18 x 5 Chebyshev table, and
    every category beside them, in both packages' packing."""
    jp, p, *_ = mech
    for q in (jp, p):
        assert q.reac_sp.shape[1] == q.prod_sp.shape[1] == 10
        assert tuple(q.cheb_coef.shape[1:]) == (18, 5)
        assert q.has_frac_nu and q.has_plog and q.has_troe
        assert q.has_thd_only and q.has_lindemann
    assert np.array_equal(np.asarray(jp.reac_sp), p.reac_sp)
    assert np.array_equal(np.asarray(jp.cheb_coef), p.cheb_coef)


def test_jax_kernels_take_the_mechanism(mech):
    """The JAX package's kernels accept the mechanism: its ``supports``
    passes, and ``PallasDDJacobianSparse(fuse_gather=True)`` builds its
    tables (no "deep" column: nu on the 2^-8 grid).  (One interpret call
    of it, a block of 512 states, takes minutes on the CPU: not run.)"""
    jp, p, *_ = mech
    assert jsupports(jp) is True and supports(p) is True
    pj = PallasDDJacobianSparse(jp, fuse_gather=True, interpret=True)
    assert pj.block_b > 0


@pytest.mark.parametrize('what', ['wide_reactions', 'cheb_high_orders'])
def test_wide_parts_move_the_outputs(mech, what):
    """The parts only the wide path computes on the card move J and f far
    beyond the metric's 1e-8: without the two wide reactions, or without
    the Chebyshev terms past order 16, the outputs differ, so a fault in
    them would show."""
    _, p, y, P, _ = mech
    if what == 'wide_reactions':
        logA = np.array(p.logA)
        logA[:2] -= 100.0
        cut = dataclasses.replace(p, logA=logA)
    else:
        coef = np.array(p.cheb_coef)
        coef[:, 16:, :] = 0.0
        cut = dataclasses.replace(p, cheb_coef=coef)
    Pt, yt = torch.as_tensor(P), torch.as_tensor(y)
    J, f = jacobian_and_dydt(p, 0.0, Pt, yt)
    Jc, fc = jacobian_and_dydt(cut, 0.0, Pt, yt)
    assert _max_rel(Jc.numpy(), J.numpy(), 1e-10) > 1e-5
    assert _max_rel(fc.numpy(), f.numpy(), 1e-6) > 1e-5


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
@pytest.mark.parametrize('name', list(MODULES))
def test_module_matches_jax(mech, jax_ref, name, conp):
    """Each f64 module's plain path against JAX's f64
    ``jacobian_and_dydt``: J floored@1e-10 and dy/dt floored@1e-6 below
    1e-8."""
    _, p, y, P, rho = mech
    J, f = MODULES[name](p, conp)(y, P if conp else rho)
    assert J.shape == (B, p.n_species, p.n_species)
    assert J.dtype == f.dtype == torch.float64
    jJ, jf = jax_ref[conp]
    assert _max_rel(J.numpy(), jJ, 1e-10) < 1e-8
    assert _max_rel(f.numpy(), jf, 1e-6) < 1e-8


@pytest.fixture(scope='module')
def jax_f32(mech):
    """conp -> (float32 param, float32 states, JAX ``PallasJacobian``'s
    (J, f) in interpret mode, JAX's f64 (J, f) on the same float32
    inputs): two interpret calls for the module."""
    jp, _, y, P, rho = mech
    out = {}
    for conp in (True, False):
        param = np.asarray(P if conp else rho, np.float32)
        y32 = np.asarray(y, np.float32)
        kJ, kf = PallasJacobian(jp, block_b=B, interpret=True,
                                conp=conp)(y32, param)
        J64, f64 = jjacobian_and_dydt(jp, 0.0, jnp.asarray(param, jnp.float64),
                                      jnp.asarray(y32, jnp.float64),
                                      conp=conp)
        out[conp] = (param, y32, (np.asarray(kJ), np.asarray(kf)),
                     (np.asarray(J64), np.asarray(f64)))
    return out


@pytest.mark.parametrize('conp', [True, False], ids=['conp', 'conv'])
def test_f32_matches_jax_kernel(mech, jax_f32, conp):
    """``F32Jacobian``'s plain path against JAX ``PallasJacobian``
    (interpret) on the same float32 inputs, with the f32 metric of
    ``tests/test_torch_f32.py``: finite share >= 0.995, J and f at 2e-5
    of scale.  Against JAX's f64 on those inputs its loss is float32's
    own: at most 1.5x the JAX f32 kernel's (each wide reaction's ln Kc
    sums 20 smh terms in float32)."""
    _, p, *_ = mech
    param, y32, kern, f64 = jax_f32[conp]
    J, f = F32Jacobian(p, conp=conp, device='cpu')(y32, param)
    assert J.dtype == f.dtype == torch.float32
    for got, want, ref in zip((J.numpy(), f.numpy()), kern, f64):
        share, err = _f32_err(got, want)
        assert share >= 0.995 and err < 2e-5, (share, err)
        share, err = _f32_err(got, ref)
        assert share >= 0.995 and err <= 1.5 * _f32_err(want, ref)[1], \
            (share, err)


def test_no_module_refuses_the_card(mech):
    """No module checks the mechanism's table sizes when it moves: none
    overrides ``nn.Module._apply``, so ``.to('cuda')`` refuses nothing
    (the device type is all a move would read); and no launcher's C entry
    checks the slot or Chebyshev dims (dims 2, 3, 5, 6)."""
    _, p, *_ = mech
    mods = [build(p, True) for build in MODULES.values()]
    mods.append(F32Jacobian(p, device='cpu'))
    for mod in mods:
        assert type(mod)._apply is nn.Module._apply, type(mod).__name__
    for src in ('sparse_stage_a.cu', 'dense_fused.cu', 'big_parts.cu'):
        text = (CSRC / src).read_text()
        assert not re.search(r'dims\[[2356]\]\s*>', text), src
        assert 'wide_tables(' in text, src


@pytest.mark.parametrize('Bp', [4099, 131072])
def test_tile_plan_takes_the_width(mech, Bp):
    """The tile planner gives K1, K4 and K3 a valid plan on a 132-SM card
    at the mechanism's width, under the shared placement (a tile of
    whole sectors where it fits one) and under the global placement."""
    _, p, *_ = mech
    for mod, dtype in ((SparseJacobian(p, device='cpu'), torch.float64),
                       (DenseJacobian(p, device='cpu'), torch.float64),
                       (F32Jacobian(p, device='cpu'), torch.float32)):
        for placement in (None, 'global'):
            plan = kernels.tile_plan(mod, dtype, Bp, 132,
                                     placement=placement)
            assert plan['placement'] == (placement or 'shared')
            assert 1 <= plan['tile'] <= kernels.TILE_THREADS
            if plan['placement'] == 'shared':
                assert plan['smem_bytes'] <= kernels.SMEM_MAX
                assert plan['grid'] == -(-Bp // plan['tile'])
            else:
                assert plan['grid'] == 132 and plan['scratch_elems'] == \
                    132 * plan['rows'] * plan['tile']
