"""The port's dense fused Jacobian (``DenseJacobian``) against the JAX
package, on the CPU.

On CPU tensors ``DenseJacobian`` runs ``dense_reference``, the plain
version of its CUDA kernel K4.  These tests hold it against the JAX
package's f64 ``jacobian_and_dydt``, its dense dd math
``jacobian_dd_xla`` (the CPU-checkable math of ``PallasDDJacobian``,
called eagerly and never jitted: a barriered dd graph takes minutes to
compile on XLA:CPU), and both reference-C goldens; they hold K4's
column tables against the plain dense columns, and ``supports`` against
the JAX package's.  The mechanisms are parsed by the JAX package and
carried over with ``packed_from_arrays``, so both sides compute from the
same numbers.  K4 itself runs only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.ops.jacobian import jacobian_and_dydt as jjacobian_and_dydt
from pyjac_tpu.testers.synthetic import (plausible_mechanism,
                                         random_states,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.constants import RU
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import packed_from_arrays
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.jacobian_big import (finish, parts_reference,
                                              state_thermo)
from pyjac_tpu_torch.ops.jacobian_dense import (DenseJacobian,
                                                dense_reference,
                                                operand_csr, supports)
from pyjac_tpu_torch.ops.jacobian_sparse import post_col_reference

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / 'data'

MECHS = {
    'flagship': lambda: plausible_mechanism(53, 325, seed=42),
    'synth': lambda: synthetic_mechanism(n_species=9, n_reactions=24,
                                         seed=7),
    'small': lambda: synthetic_mechanism(n_species=6, n_reactions=10,
                                         seed=7, gri_mix=True),
}
_CACHE = {}


def _mech(tmp_path_factory, name):
    """(JAX mech, JAX packed, port packed from the JAX arrays)."""
    if name not in _CACHE:
        path = tmp_path_factory.mktemp(name) / 'm.inp'
        path.write_text(MECHS[name]())
        jm = JMechanism.from_files(str(path))
        jp = jpack(jm)
        fields = {k: getattr(jp, k) for k in jp.__dataclass_fields__
                  if k != 'mech'}
        p = packed_from_arrays(fields, Mechanism.from_files(str(path)))
        _CACHE[name] = (jm, jp, p)
    return _CACHE[name]


def _states(jm, p, name, B=64):
    if name == 'flagship':
        d = np.load(DATA / 'flagship_states.npz')
        return d['y'][:B], d['P'][:B]
    y, _, P = random_states(jm, B, seed=3)
    return y, P


def _density(p, y, P):
    """Each state's own density (CONV takes density)."""
    Yf = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)], 1)
    return P / (RU * y[:, 0] * (Yf * p.inv_mw).sum(1))


def _floored(a, b, floor):
    a = np.asarray(a).reshape(len(b), -1)
    b = np.asarray(b).reshape(len(b), -1)
    denom = np.maximum(np.abs(b),
                       np.abs(b).max(-1, keepdims=True) * floor + 1e-300)
    return float((np.abs(a - b) / denom).max())


def _norm_rel(a, b):
    a = np.asarray(a).reshape(len(b), -1)
    b = np.asarray(b).reshape(len(b), -1)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('conp', [True, False])
def test_matches_jax_f64(tmp_path_factory, name, conp):
    """64 states (flagship PaSR; the all-features synth's random draw)
    against the JAX f64 ``jacobian_and_dydt``: J floored@1e-10 < 1e-10,
    dy/dt norm-relative < 1e-7."""
    jm, jp, p = _mech(tmp_path_factory, name)
    y, P = _states(jm, p, name)
    param = P if conp else _density(p, y, P)
    J, f = DenseJacobian(p, conp=conp, device='cpu')(y, param)
    jJ, jf = jjacobian_and_dydt(jp, 0.0, jnp.asarray(param), jnp.asarray(y),
                                conp=conp)
    assert J.shape == (64, p.n_species, p.n_species)
    assert J.dtype == f.dtype == torch.float64
    assert _floored(J.numpy(), np.asarray(jJ), 1e-10) < 1e-10
    assert _norm_rel(f.numpy(), np.asarray(jf)) < 1e-7


def test_matches_jax_dense_dd_math(tmp_path_factory):
    """The 6/10 synth at B = 8 against ``jacobian_dd_xla`` (the JAX dense
    dd kernel's math on the CPU, eager): J floored@1e-10 < 1e-9 and dy/dt
    norm-relative < 1e-9 (the dd side carries ~2^-48 pairs)."""
    from pyjac_tpu.ops.pallas_dd import jacobian_dd_xla
    jm, jp, p = _mech(tmp_path_factory, 'small')
    y, P = _states(jm, p, 'small', B=8)
    Jdd, fdd = jacobian_dd_xla(jp, P, y)
    J, f = DenseJacobian(p, device='cpu')(y, P)
    assert _floored(J.numpy(), np.asarray(Jdd), 1e-10) < 1e-9
    assert _norm_rel(f.numpy(), np.asarray(fdd)) < 1e-9


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_golden(tmp_path_factory, name):
    """Both reference-C goldens (J in the reference's column-major
    layout): the flagship at ``test_golden_parity``'s metric (J
    floored@1e-10 < 1e-8, dy/dt norm-relative < 1e-7), the all-features
    synth at ``TestAllFeaturesGolden``'s (J floored@1e-9 < 1e-8, dy/dt
    floored@1e-9 < 1e-10)."""
    _, _, p = _mech(tmp_path_factory, name)
    g = np.load(DATA / ('golden_%s_refc.npz' % name))
    n = len(g['T'])
    J, f = DenseJacobian(p, device='cpu')(g['y'], g['P'])
    Jl = J.numpy().transpose(0, 2, 1).reshape(n, -1)
    if name == 'flagship':
        assert _floored(Jl, g['ref_jac'], 1e-10) < 1e-8
        assert _norm_rel(f.numpy(), g['ref_dydt']) < 1e-7
    else:
        assert _floored(Jl, g['ref_jac'], 1e-9) < 1e-8
        assert _floored(f.numpy(), g['ref_dydt'], 1e-9) < 1e-10


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('conp', [True, False])
def test_operand_tables_give_the_dense_columns(tmp_path_factory, name,
                                               conp):
    """K4's column tables (``operand_csr``): contracting the role array
    row by row as the kernel does, then ``_post_col``, gives the plain
    dense columns to roundoff (floored@1e-10 < 1e-12 of J)."""
    jm, _, p = _mech(tmp_path_factory, name)
    y, P = _states(jm, p, name, B=16)
    param = P if conp else _density(p, y, P)
    y_t = torch.as_tensor(y.T.copy())
    P_t = torch.as_tensor(np.asarray(param)[None].copy())
    st = state_thermo(p, y_t, P_t, conp)
    roles = parts_reference(p, st, conp)
    post = finish(p, st, roles, conp)['post']
    ptr, row, coef = operand_csr(p)
    N, J = p.n_species, p.n_species - 1
    flat = roles.reshape(-1, roles.shape[-1])
    terms = torch.as_tensor(coef)[:, None] * flat[torch.as_tensor(
        row.astype(np.int64))]
    seg = np.repeat(np.arange(J * N), np.diff(ptr))
    dcol = torch.zeros((J * N, flat.shape[1]), dtype=torch.float64)
    dcol.index_add_(0, torch.as_tensor(seg), terms)
    cols = post_col_reference(dcol.view(J, N, -1), torch.arange(J),
                              torch.as_tensor(p.inv_mw), post, conp)
    Jt, _ = dense_reference(p, y_t, P_t, conp)
    assert _floored(cols.permute(2, 0, 1).numpy(),
                    Jt[1:].permute(2, 0, 1).numpy(), 1e-10) < 1e-12


def test_supports_matches_jax(tmp_path_factory):
    """``supports`` agrees with the JAX package's on the flagship, the
    all-features synth and a sign-flipping PLOG table, which it refuses
    and ``DenseJacobian`` raises on."""
    from pyjac_tpu.ops.pallas_dd import supports as jsupports
    for name in ('flagship', 'synth'):
        _, jp, p = _mech(tmp_path_factory, name)
        assert supports(p) == jsupports(jp) is True
    _, jp, p = _mech(tmp_path_factory, 'synth')
    assert p.has_plog
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    jbad = dataclasses.replace(jp, plog_sign=sign)
    bad = dataclasses.replace(p, plog_sign=sign)
    assert supports(bad) == jsupports(jbad) is False
    with pytest.raises(NotImplementedError, match='PLOG'):
        DenseJacobian(bad, device='cpu')


def test_rejects_wrong_state_width(tmp_path_factory):
    """A (B, N') batch of another width raises ValueError up front
    (``test_pallas_dd.py::test_kernel_rejects_wrong_state_width``)."""
    _, _, p = _mech(tmp_path_factory, 'small')
    dj = DenseJacobian(p, device='cpu')
    with pytest.raises(ValueError, match='states must be'):
        dj(np.ones((8, p.n_species + 1)), np.full(8, 101325.0))
    with pytest.raises(ValueError, match='states must be'):
        dj(np.ones(p.n_species), 101325.0)


def test_default_device_is_the_card(tmp_path_factory):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, _, p = _mech(tmp_path_factory, 'small')
    with pytest.raises(RuntimeError, match='CUDA'):
        DenseJacobian(p)


def test_launcher_refuses_cpu_tensors(tmp_path_factory):
    """No fallback: the K4 launcher given CPU tensors raises, builds
    nothing and counts no launch."""
    _, _, p = _mech(tmp_path_factory, 'small')
    dj = DenseJacobian(p, device='cpu')
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match='CUDA'):
        kernels.dense_fused(dj, torch.zeros((dj.N, 4), dtype=torch.float64),
                            torch.ones((1, 4), dtype=torch.float64))
    assert kernels.launches == before and kernels._lib is None
