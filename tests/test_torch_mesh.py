"""The port's ``parallel.mesh`` on the CPU.

Like ``tests/test_parallel.py`` for the JAX package: ``pad_batch``,
``make_mesh`` and ``batch_sharding``; the sharded steps over a mesh of
virtual CPU shards against the unsharded calls, bit for bit (every
operation is per state; on the CPU the plain versions' batched products
round alike where each shard holds a multiple of 16 states, so the
shards here do), with the JAX package's norms; ``sharded_step`` against
the JAX package's on an 8-device virtual mesh; ``BatchEvaluator`` over
such a mesh against its one-device path; a process group's mesh and
card; and the dry run across two gloo processes.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt
from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian
from pyjac_tpu_torch.parallel import mesh as pm
from pyjac_tpu_torch.parallel.batch import BatchEvaluator
from pyjac_tpu_torch.testers.synthetic import (flagship, packed_from_text,
                                               random_states,
                                               synthetic_mechanism)

torch.set_num_threads(1)


def jax_norm(J, f, spans=None):
    """The JAX package's norm of a step (``pyjac_tpu/parallel/mesh.py``):
    max|J| + max|f| over the batch (``sharded_step``), or over ``spans``,
    the largest shard's (the dd steps: the sum on each shard, then the
    ``pmax``).  J and f batch-major."""
    top = lambda x: float(x.abs().max())
    if spans is None:
        return top(J) + top(f)
    return max(top(J[s:e]) + top(f[s:e]) for s, e in spans)


@pytest.fixture(scope='module')
def mechs():
    """name -> (packed, 96 random states, pressures) for the flagship and
    the all-features 9/24 synth."""
    out = {}
    for name, (mech, p) in (('flagship', flagship()),
                            ('synth', packed_from_text(
                                synthetic_mechanism(9, 24, seed=7)))):
        y, _, P = random_states(mech, 96, seed=3)
        out[name] = (p, torch.as_tensor(np.ascontiguousarray(y)),
                     torch.as_tensor(P))
    return out


def test_pad_batch():
    assert pm.pad_batch(1020, 8) == 1024
    assert pm.pad_batch(1024, 8) == 1024
    assert pm.pad_batch(1, 8) == 8


def test_make_mesh():
    """One CPU shard by default, n virtual ones on request; the default
    device is the card, absent here."""
    mesh = pm.make_mesh(device='cpu')
    assert mesh.size == 1 and mesh.devices == (torch.device('cpu'),)
    assert (mesh.rank, mesh.world) == (0, 1)
    mesh4 = pm.make_mesh(4, device='cpu')
    assert mesh4.size == 4 and len(set(mesh4.devices)) == 1
    with pytest.raises(RuntimeError, match='CUDA'):
        pm.make_mesh()
    with pytest.raises(ValueError):
        pm.make_mesh(0, device='cpu')


@pytest.mark.parametrize('n,size', [(64, 8), (100, 8), (3, 4), (0, 2)])
def test_batch_sharding(n, size):
    """Contiguous blocks of ceil(n / size) states, in shard order, that
    cover [0, n) once (the last shorter or empty)."""
    mesh = pm.make_mesh(size, device='cpu')
    spans = pm.batch_sharding(mesh, n)
    assert len(spans) == size
    assert [s[0] for s in spans] == [0] * size
    per = -(-n // size)
    assert spans[0][2] == 0 and spans[-1][3] == n
    for (_, _, _, e), (_, _, s, _) in zip(spans, spans[1:]):
        assert e == s
    assert all(e - s <= per for _, _, s, e in spans)


def test_batch_sharding_across_processes():
    """Process k holds shards k * devices .. of the mesh: a mesh of 2
    devices in a group of 3 has 6 shards, this process's first two."""
    mesh = pm.Mesh((torch.device('cpu'),) * 2, rank=1, world=3)
    spans = pm.batch_sharding(mesh, 60)
    assert [s[0] for s in spans] == [0, 0, 1, 1, 2, 2]
    assert pm._local_shards(mesh, 60) == [(torch.device('cpu'), 20, 30),
                                          (torch.device('cpu'), 30, 40)]


@pytest.mark.parametrize('name', ['flagship', 'synth'])
@pytest.mark.parametrize('step_fn,whole', [
    ('sharded_step', lambda p, y, P: jacobian_and_dydt(p, 0.0, P, y)),
    ('sharded_jacobian_dd_xla', lambda p, y, P: DenseJacobian(
        p, device='cpu')(y, P)),
    ('sharded_jacobian_dd_xla_sparse', lambda p, y, P: SparseJacobian(
        p, device='cpu')(y, P))])
def test_sharded_steps_equal_unsharded(mechs, name, step_fn, whole):
    """48 states over 3 virtual CPU shards of 16: J and f equal the
    unsharded call bit for bit; the norm is the JAX package's, from the
    unsharded J and f (over the batch for ``sharded_step``, the largest
    shard's for the dd steps), exactly."""
    p, y, P = mechs[name]
    y, P = y[:48], P[:48]
    step = getattr(pm, step_fn)(p, pm.make_mesh(3, device='cpu'))
    J, f, norm = step(y, P)
    J0, f0 = whole(p, y, P)
    assert torch.equal(J, J0) and torch.equal(f, f0)
    spans = None if step_fn == 'sharded_step' else [(0, 16), (16, 32),
                                                    (32, 48)]
    assert float(norm) == jax_norm(J0, f0, spans)


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_sharded_step_dd_equals_unsharded(mechs, name):
    """K4's step (its plain version here) on 48 batch-minor states over 3
    virtual shards: Jt and f equal ``DenseJacobian.call_tr``'s bit for
    bit, and a process with no states gets empty outputs."""
    p, y, P = mechs[name]
    y, P = y[:48], P[:48]
    y_t, P_t = y.T.contiguous(), P[None].contiguous()
    step = pm.sharded_step_dd(p, pm.make_mesh(3, device='cpu'))
    Jt, f, norm = step(y_t, P_t)
    Jt0, f0 = DenseJacobian(p, device='cpu').call_tr(y_t, P_t)
    assert torch.equal(Jt, Jt0) and torch.equal(f, f0)
    assert float(norm) == jax_norm(Jt0.permute(2, 1, 0), f0.T,
                                   [(0, 16), (16, 32), (32, 48)])
    N = p.n_species
    Jt, f, norm = step(y_t[:, :0], P_t[:, :0])
    assert Jt.shape == (N, N, 0) and f.shape == (N, 0) and float(norm) == 0


def test_sharded_step_matches_jax(tmp_path):
    """``sharded_step`` against the JAX package's on the same numpy
    states, each over its mesh: 8 virtual CPU devices (conftest) and 8
    virtual shards.  J and f agree to 1e-12 of their scale, the norm
    (max|J| + max|f| over the batch) to 1e-12 of itself."""
    import jax.numpy as jnp
    from pyjac_tpu.core.mech import Mechanism as JMechanism
    from pyjac_tpu.core.pack import pack as jpack
    from pyjac_tpu.parallel import mesh as jm
    text = synthetic_mechanism(9, 24, seed=7)
    path = tmp_path / 'm.inp'
    path.write_text(text)
    jmech = JMechanism.from_files(str(path))
    y, _, P = random_states(jmech, 64, seed=3)
    y = np.ascontiguousarray(y)
    Jj, fj, nj = jm.sharded_step(jpack(jmech), jm.make_mesh(8))(
        jnp.asarray(y), jnp.asarray(P))
    p = packed_from_text(text)[1]
    J, f, norm = pm.sharded_step(p, pm.make_mesh(8, device='cpu'))(
        torch.as_tensor(y), torch.as_tensor(P))
    for a, b in ((J, Jj), (f, fj)):
        b = np.asarray(b)
        scale = np.abs(b).max()
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-12,
                                   rtol=0)
    assert abs(float(norm) - float(nj)) <= 1e-12 * float(nj)


def test_make_mesh_in_a_group_takes_this_ranks_card(monkeypatch):
    """In a process group a CUDA mesh is this process's one card, the
    current device that ``initialize_distributed`` selected, never every
    card of the node (NCCL takes one process a card).  The group and
    the cards are stand-ins here: rank 1 of 2, two cards."""
    monkeypatch.setattr(pm, 'entry_device', lambda d: torch.device('cuda'))
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_rank', lambda: 1)
    monkeypatch.setattr(dist, 'get_world_size', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 1)
    mesh = pm.make_mesh()
    assert mesh.devices == (torch.device('cuda', 1),)
    assert (mesh.rank, mesh.world, mesh.size) == (1, 2, 2)
    assert pm.make_mesh(1).devices == mesh.devices
    with pytest.raises(ValueError):
        pm.make_mesh(2)
    assert pm._local_shards(mesh, 10) == [(torch.device('cuda', 1), 5, 10)]


@pytest.mark.parametrize('local_rank,want', [(None, 1), ('0', 0)])
def test_initialize_distributed_selects_the_local_rank_card(
        monkeypatch, local_rank, want):
    """On the card each process joins NCCL and takes the card of its
    local rank: ``LOCAL_RANK`` where set, else its rank modulo the cards
    (rank 3 of 4 on two cards: card 1).  The group and the cards are
    stand-ins here."""
    seen = {}
    monkeypatch.setattr(pm, 'entry_device', lambda d: torch.device('cuda'))
    monkeypatch.setattr(dist, 'is_initialized', lambda: False)
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    monkeypatch.setattr(dist, 'get_rank', lambda: 3)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: seen.update(card=d))
    if local_rank is None:
        monkeypatch.delenv('LOCAL_RANK', raising=False)
    else:
        monkeypatch.setenv('LOCAL_RANK', local_rank)
    pm.initialize_distributed('localhost:1234', 4, 3)
    assert seen == dict(backend='nccl', init_method='tcp://localhost:1234',
                        world_size=4, rank=3, card=want)


def test_batch_evaluator_mesh_equals_one_device(mechs):
    """``BatchEvaluator(mesh=...)``, each chunk of 48 split over 3 virtual
    shards of 16, equals the ``mesh=None`` path: dydt, the plain Jacobian and
    ``jacobian_dd`` bit for bit, its checksum to roundoff (the sums are
    grouped by shard); the device-resident loop takes one device."""
    p, y, P = mechs['flagship']
    y, P = y.numpy(), P.numpy()
    one = BatchEvaluator(p, chunk_size=48, device='cpu')
    ev = BatchEvaluator(p, pm.make_mesh(3, device='cpu'), chunk_size=48)
    assert ev.device == torch.device('cpu')
    assert np.array_equal(ev.dydt(y, P), one.dydt(y, P))
    for a, b in zip(ev.jacobian(y, P), one.jacobian(y, P)):
        assert np.array_equal(a, b)
    J, f = one.jacobian_dd(y, P)
    for a, b in zip(ev.jacobian_dd(y, P), (J, f)):
        assert np.array_equal(a, b)
    gross = np.abs(J).sum() + np.abs(f).sum()
    assert abs(ev.jacobian_dd(y, P, return_results=False) -
               one.jacobian_dd(y, P, return_results=False)) < 1e-12 * gross
    with pytest.raises(ValueError):
        ev.jacobian_dd_resident(y, P)
    with pytest.raises(ValueError):
        BatchEvaluator(p, pm.Mesh((torch.device('cpu'),), rank=0, world=2))


def test_initialize_distributed_without_address_is_a_no_op():
    pm.initialize_distributed()
    assert not dist.is_initialized()


def test_dryrun_multichip_two_gloo_processes(capfd):
    """Two gloo processes, 32 of the 64 flagship PaSR states each:
    ``sharded_step`` and ``sharded_jacobian_dd_xla_sparse`` gathered
    equal the unsharded calls bit for bit, each process's norm the JAX
    package's."""
    pm.dryrun_multichip(2)
    out = capfd.readouterr().out
    assert out.count('bit for bit') == 2, out
    assert 'shards [(0, 32), (32, 64)]' in out
