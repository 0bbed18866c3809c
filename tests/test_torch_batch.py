"""The port's ``BatchEvaluator`` against the JAX package, on the CPU.

``BatchEvaluator(device='cpu')`` runs the plain float64 functions and
the kernels' plain versions chunk by chunk.  These tests hold its
``dydt`` / ``jacobian`` against the JAX package's ``BatchEvaluator`` on
a one-device mesh at ``test_parallel.py``'s 1e-12 of scale, its
``jacobian_dd`` against the float64 ``jacobian_and_dydt``, and its
device-resident loop against a direct whole-array checksum; they check
the kernel route (K1 + K2; K4 only where ``SparseJacobian`` refuses, as
the JAX package's ``mesh.py`` chooses).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.parallel.mesh import BatchEvaluator as JBatchEvaluator
from pyjac_tpu.parallel.mesh import make_mesh
from pyjac_tpu.testers.synthetic import (plausible_mechanism, random_states,
                                         synthetic_mechanism)
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import packed_from_arrays
from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian
from pyjac_tpu_torch.parallel import batch
from pyjac_tpu_torch.parallel.batch import BatchEvaluator

torch.set_num_threads(1)


# the stats keys of the JAX package's jacobian_dd_resident (mesh.py:258-265)
JAX_RESIDENT_KEYS = {'states', 'chunk_b', 'n_chunks', 'staging_s',
                     'staging_bytes', 'staging_mb_s', 'compile_s',
                     'compute_s', 'pass_s', 'evals_per_s'}


@pytest.fixture(scope='module')
def mechs(tmp_path_factory):
    """name -> (JAX packed, port packed from the JAX arrays, 40 random
    states, pressures) for the flagship and the all-features synth.  (The
    PaSR states sit near equilibrium, where dy/dt cancels to ~1e-9 of its
    terms: two summation orders then differ above 1e-12.)"""
    out = {}
    for name, text in (('flagship', plausible_mechanism(53, 325, seed=42)),
                       ('synth', synthetic_mechanism(n_species=9,
                                                     n_reactions=24, seed=7))):
        path = tmp_path_factory.mktemp(name) / 'm.inp'
        path.write_text(text)
        jm = JMechanism.from_files(str(path))
        jp = jpack(jm)
        fields = {k: getattr(jp, k) for k in jp.__dataclass_fields__
                  if k != 'mech'}
        p = packed_from_arrays(fields, Mechanism.from_files(str(path)))
        y, _, P = random_states(jm, 40, seed=3)
        out[name] = (jp, p, y, P)
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_dydt_and_jacobian_match_jax(mechs):
    """40 random flagship states in chunks of 16 (a ragged tail of 8): the
    port's ``dydt`` and ``jacobian`` against JAX ``BatchEvaluator`` on a
    one-device mesh, at 1e-12 of scale (``test_parallel.py:60-64``)."""
    jp, p, y, P = mechs['flagship']
    jev = JBatchEvaluator(jp, make_mesh(1), chunk_size=16)
    ev = BatchEvaluator(p, chunk_size=16, device='cpu')
    jJ, jf = jev.jacobian(y, P)
    J, f = ev.jacobian(y, P)
    assert J.shape == (40, 53, 53) and f.shape == (40, 53)
    assert _rel(J, np.asarray(jJ)) < 1e-12
    assert _rel(f, np.asarray(jf)) < 1e-12
    assert _rel(ev.dydt(y, P), np.asarray(jev.dydt(y, P))) < 1e-12


@pytest.mark.parametrize('name,route', [('flagship', SparseJacobian),
                                        ('synth', SparseJacobian)])
def test_jacobian_dd_route_and_results(mechs, name, route):
    """The parity-precision route is K1 + K2 (``SparseJacobian``) for the
    flagship and for the all-features synth (PLOG, Chebyshev, SRI,
    chemically activated, fractional nu), as in the JAX package, whose
    sparse pipeline takes both; ``jacobian_dd`` over chunks of 16 matches the
    float64 ``jacobian_and_dydt`` at the parity metric of
    ``test_golden_parity.py`` (J floored@1e-10 < 1e-8; the sparse pipeline
    sums in another order and reads 5.8e-10 here) and f at 1e-10 of scale,
    and its checksum mode sums the same outputs."""
    _, p, y, P = mechs[name]
    ev = BatchEvaluator(p, chunk_size=16, device='cpu')
    assert type(ev._dd_kernel()) is route
    J, f = ev.jacobian_dd(y, P)
    rJ, rf = jacobian_and_dydt(p, 0.0, torch.as_tensor(P), torch.as_tensor(y))
    rJ, rf = rJ.numpy(), rf.numpy()
    denom = np.maximum(np.abs(rJ), np.abs(rJ).max((1, 2), keepdims=True)
                       * 1e-10)
    assert float((np.abs(J - rJ) / denom).max()) < 1e-8
    assert _rel(f, rf) < 1e-10
    chk = ev.jacobian_dd(y, P, return_results=False)
    gross = np.abs(J).sum() + np.abs(f).sum()
    assert abs(chk - (J.sum() + f.sum())) < 1e-12 * gross


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_resident_covers_every_state_once(mechs, name):
    """``jacobian_dd_resident`` in chunks of 16 over 40 states (a ragged
    tail of 8, not padded): its checksum equals the sum of every output
    of one direct call on all 40 states, and its stats carry the JAX
    package's keys plus the module that ran."""
    _, p, y, P = mechs[name]
    ev = BatchEvaluator(p, device='cpu')
    chk, st = ev.jacobian_dd_resident(y, P, chunk_b=16, passes=2)
    mod = ev._dd_kernel()
    outs = mod.call_tr(torch.as_tensor(y.T.copy()),
                       torch.as_tensor(P[None].copy()))
    direct = sum(float(x.sum()) for x in outs)
    gross = sum(float(x.abs().sum()) for x in outs)
    assert abs(chk - direct) < 1e-12 * gross
    assert set(st) - JAX_RESIDENT_KEYS == {'kernel'}
    assert JAX_RESIDENT_KEYS <= set(st)
    assert st['kernel'] == type(mod).__name__
    assert (st['states'], st['chunk_b'], st['n_chunks']) == (40, 16, 3)
    assert st['staging_bytes'] == 40 * (p.n_species + 1) * 8
    assert len(st['pass_s']) == 2 and st['compute_s'] == min(st['pass_s'])


H100_BYTES = 85520809984      # an H100 80GB HBM3's total_memory


def test_resident_default_chunk_fits_the_device(mechs):
    """``jacobian_dd_resident``'s default chunk: the flagship keeps its
    131072 states on an H100 and the 654-species class takes no more
    than keep J and dy/dt within the stated share of the card; on the
    host nothing but 131072 caps it (here the whole 40 states)."""
    assert batch.resident_chunk(53, 10 ** 6, H100_BYTES) == 131072
    assert batch.resident_chunk(53, 4096, H100_BYTES) == 4096
    n654 = batch.resident_chunk(654, 10 ** 6, H100_BYTES)
    per_state = (654 * 654 + 654) * 8
    assert n654 * per_state <= batch.RESIDENT_OUTPUT_SHARE * H100_BYTES \
        < (n654 + 1) * per_state
    assert batch.resident_chunk(654, 100, H100_BYTES) == 100
    assert batch.resident_chunk(654, 10, per_state) == 1
    assert batch.resident_chunk(654, 10 ** 6) == 131072
    _, p, y, P = mechs['flagship']
    _, st = BatchEvaluator(p, device='cpu').jacobian_dd_resident(
        y, P, passes=1)
    assert (st['chunk_b'], st['n_chunks']) == (40, 1)


def test_refused_mechanism_drops_to_dense_as_jax(mechs):
    """A sign-flipping PLOG table: ``SparseJacobian`` refuses it, so
    ``_dd_kernel`` builds ``DenseJacobian``, which refuses it too, as the
    JAX package's ``BatchEvaluator`` drops from ``PallasDDJacobianSparse``
    to ``PallasDDJacobian``, which raises."""
    jp, p, _, _ = mechs['synth']
    sign = np.array(p.plog_sign)
    sign[0, 0] = -1.0
    bad = dataclasses.replace(p, plog_sign=sign)
    with pytest.raises(NotImplementedError, match='SparseJacobian'):
        SparseJacobian(bad, device='cpu')
    with pytest.raises(NotImplementedError, match='DenseJacobian'):
        BatchEvaluator(bad, device='cpu')._dd_kernel()
    jev = JBatchEvaluator(dataclasses.replace(jp, plog_sign=sign),
                          make_mesh(1))
    with pytest.raises(NotImplementedError):
        jev._dd_kernel(64)


def test_default_device_is_the_card(mechs):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    _, p, _, _ = mechs['synth']
    with pytest.raises(RuntimeError, match='CUDA'):
        BatchEvaluator(p)
