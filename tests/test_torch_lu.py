"""The integrator's iteration-matrix factor and solve on the CPU
(``integrate.lu_factor`` / ``lu_solve``): the plain path forms W = I - s J
from either layout of the stage Jacobian and factors it with the library,
the path is chosen by the matrix's width and device alone, and off the
card nothing launches or counts.  The kernels themselves
(``csrc/batched_lu.cu``) run on the card only: ``tests/test_torch_cuda.py``
holds them against the library there."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyjac_tpu_torch import profiling
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
from pyjac_tpu_torch.testers.synthetic import flagship, random_states

integ = importlib.import_module('pyjac_tpu_torch.integrate')


def _stage_jacobian(B):
    """The plain K4's Jt (N, N, B) on B flagship states and (B,) scales."""
    mech, p = flagship()
    y, _, P = random_states(mech, B, seed=11)
    Jt, _ = DenseJacobian(p, device='cpu').call_tr(
        torch.as_tensor(np.ascontiguousarray(y.T)),
        torch.as_tensor(P[None].copy()))
    s = 10.0 ** np.random.default_rng(2).uniform(-11, -5, B)
    return Jt, torch.as_tensor(s)


@pytest.mark.parametrize('layout', ['dd', 'xla'])
def test_plain_lu_factor_forms_w(layout):
    """Off the card ``lu_factor(J, s)`` is ``lu_factor_ex(I - s J)`` bit
    for bit, J as K4 leaves it (a (column, row, batch) array permuted)
    or contiguous, and ``lu_solve`` is the library's solve."""
    Jt, s = _stage_jacobian(16)
    J = Jt.permute(2, 1, 0)
    if layout == 'xla':
        J = J.contiguous()
    LU, piv, ok = integ.lu_factor(J, s)
    W = torch.eye(J.shape[-1], dtype=J.dtype) - s[:, None, None] * J
    LUr, pivr, info = torch.linalg.lu_factor_ex(W, check_errors=False)
    assert torch.equal(LU, LUr) and torch.equal(piv, pivr)
    assert torch.equal(ok, info == 0) and bool(ok.all())
    rhs = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (16, J.shape[-1])))
    x = torch.linalg.lu_solve(LUr, pivr, rhs[..., None])[..., 0]
    assert torch.equal(integ.lu_solve((LU, piv, ok), rhs), x)


def test_lu_path_is_chosen_by_shape():
    """The kernels take a CUDA tensor whose N fits one block's shared
    memory, every N up to ``LU_MAX_N`` (the C side's count of a state's
    bytes: an odd row stride, the pivot slots, two row orders and the
    pivots);
    anything else, and every CPU
    tensor, takes the library.  Each tile the planner picks fits."""
    assert kernels.lu_state_bytes(53) == 53 * 53 * 8 + 32 + 3 * 53 * 4
    assert kernels.lu_state_bytes(54) == 54 * 55 * 8 + 32 + 3 * 54 * 4
    n = kernels.LU_MAX_N
    assert kernels.lu_state_bytes(n) <= kernels.SMEM_MAX \
        < kernels.lu_state_bytes(n + 1)
    assert n == 169

    def card(*shape):
        return SimpleNamespace(device=torch.device('cuda', 0), shape=shape)
    assert kernels.lu_on_chip(card(8, 53, 53))
    assert kernels.lu_on_chip(card(8, n, n))
    assert kernels.lu_on_chip(card(8, n))
    assert not kernels.lu_on_chip(card(8, n + 1, n + 1))
    assert not kernels.lu_on_chip(torch.zeros((8, 53, 53)))
    for N in range(1, n + 1):
        ts = kernels.lu_tile(N)
        assert ts in (1, 2)
        assert ts * kernels.lu_state_bytes(N) <= kernels.SMEM_MAX
    assert kernels.lu_tile(53) == 2 and kernels.lu_tile(n) == 1


def test_lu_kernel_counter_stays_zero_on_cpu():
    """A profiled integration on the CPU launches no LU kernel, builds
    nothing and counts no ``integrate.lu_kernel``."""
    mech, p = flagship()
    y, _, P = random_states(mech, 4, seed=3)
    before = dict(kernels.launches)
    profiling.counters.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        res = integ.integrate(p, y, P, 1e-9, rtol=1e-3, atol=1e-6,
                              max_steps=6, jacobian='dd', device='cpu')
    assert res.iterations > 0
    assert profiling.counters.get('integrate.lu_kernel', 0) == 0
    assert profiling.counters['integrate.state_slots'] == 4 * res.iterations
    assert kernels.launches == before and kernels._lib is None
    profiling.counters.clear()


@pytest.mark.parametrize('layout', ['dd', 'xla'])
def test_lu_operators_on_meta(layout):
    """The operators' fake implementations (what a trace reads): LU (B,
    N, N) float64, pivots (B, N) int32, ok (B,) bool from J of either
    layout, as the library's; the solve's x has the right-hand side's
    shape."""
    B, N = 7, 5
    J = torch.empty((N, N, B), dtype=torch.float64,
                    device='meta').permute(2, 1, 0)
    if layout == 'xla':
        J = torch.empty((B, N, N), dtype=torch.float64, device='meta')
    s = torch.empty((B,), dtype=torch.float64, device='meta')
    ops = torch.ops.pyjac_tpu_torch
    LU, piv, ok = ops.lu_factor(J, s)
    assert (LU.shape, LU.dtype) == ((B, N, N), torch.float64)
    assert (piv.shape, piv.dtype) == ((B, N), torch.int32)
    assert (ok.shape, ok.dtype) == ((B,), torch.bool)
    rhs = torch.empty((B, N), dtype=torch.float64, device='meta')
    x = ops.lu_solve(LU, piv, rhs)
    assert (x.shape, x.dtype) == ((B, N), torch.float64)


def test_lu_operators_refuse_cpu_tensors():
    """The operators have one implementation, for CUDA: no CPU fallback
    (the integrator's plain path never calls them)."""
    J = torch.zeros((2, 3, 3), dtype=torch.float64)
    s = torch.zeros((2,), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        torch.ops.pyjac_tpu_torch.lu_factor(J, s)
    with pytest.raises(NotImplementedError):
        torch.ops.pyjac_tpu_torch.lu_solve(
            torch.zeros((2, 3, 3), dtype=torch.float64),
            torch.ones((2, 3), dtype=torch.int32), torch.zeros((2, 3)))
