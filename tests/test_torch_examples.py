"""The port's examples (``pyjac_tpu_torch.examples``) on the CPU, against
the JAX package.

``ignition_delay`` runs its bisection with the plain versions (the stage
Jacobian from ``dense_reference``, K4's plain version) on a small grid of
the flagship's unburnt PaSR rows; its delays are held against JAX's
``pyjac_tpu.ignition_delay`` on the same packed mechanism (parsed by the
JAX package from the same text) and the same initial states.
``multichip_batch`` runs on 4 virtual CPU shards, each a multiple of 16
states, so its sharded step and its chunked ``BatchEvaluator`` equal the
unsharded calls bit for bit (the plain versions' batched products round
alike across batch sizes there).  On the card ``chip_smoke.py`` runs
both (phase 19).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.integrate import ignition_delay as jignition_delay
from pyjac_tpu_torch.examples import ignition_delay, multichip_batch
from pyjac_tpu_torch.ops.jacobian import jacobian_and_dydt
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian
from pyjac_tpu_torch.testers.synthetic import plausible_mechanism

torch.set_num_threads(1)


def test_ignition_delay_example_matches_jax(tmp_path, capsys):
    """2 temperatures x 1 mixture, 6 bisection probes over 4e-4 s (rtol
    1e-5): both states ignite (each delay below t_end (1 - 2^-6), where a
    state that never ignites would end at t_end (1 - 2^-7)), measured
    2.03e-4 and 1.56e-5 s, each a few brackets from either end; the
    example's delays equal JAX's bisection on the same states, to one
    bracket of the bisection (t_end / 2^6; both integrators take the
    same steps, so the brackets agree unless a probe's T sits on the
    threshold within roundoff).  It prints the JAX script's table and the
    count of states that ignited."""
    out = ignition_delay.main(['--device', 'cpu', '--temps', '2',
                               '--mixtures', '1', '--points', '4',
                               '--t-range', '950', '1000',
                               '--t-end', '4e-4', '--rtol', '1e-5'])
    text = capsys.readouterr().out
    assert 'ignition delay [ms]' in text and 'T0[K]:' in text
    assert 'ignited: 2 of 2 states' in text
    tau = out['tau']
    bracket = out['t_end'] / 2 ** 6
    assert tau.shape == (1, 2) and np.isfinite(tau).all()
    assert (tau > bracket).all() and (tau < out['t_end'] - bracket).all()
    assert out['ignited'].all()
    path = tmp_path / 'flagship.inp'
    path.write_text(plausible_mechanism(n_species=53, n_reactions=325,
                                        seed=42))
    jp = jpack(JMechanism.from_files(str(path)))
    ref = np.asarray(jignition_delay(
        jp, jnp.asarray(out['y0']), jnp.asarray(out['P']), out['t_end'],
        threshold=out['threshold'], n_points=4, rtol=out['rtol']))
    assert (ref < out['t_end'] - bracket).all(), ref
    assert np.abs(tau.ravel() - ref).max() <= bracket, (tau, ref)


def test_ignition_delay_flags_states_that_never_ignite():
    """``ignited`` tells a delay that a probe found from the one left when
    none did: with no ignition the bisection ends at t_end (1 - 2^-(n +
    1)) after n probes, with one at the last probe just under t_end (1 -
    2^-n), and at the first probe at most t_end / 2."""
    n = 6    # probes for n_points = 4
    t_end = 1e-3
    never = t_end * (1 - 2.0 ** -(n + 1))
    last = t_end * (1 - 2.0 ** -n) - t_end * 2.0 ** -(n + 1)
    assert ignition_delay.ignited(
        [never, last, 0.5 * t_end, t_end / 2 ** (n + 1)], t_end, 4).tolist() \
        == [False, True, True, True]


def test_ignition_delay_example_mixtures(capsys):
    """The default mixtures, the flagship's unburnt rows (coolest quarter,
    distinct), each mixture at every T0."""
    from pyjac_tpu_torch.testers.synthetic import flagship
    mech, packed = flagship()
    T0 = np.array([1000.0, 1200.0, 1400.0])
    y0, P, labels = ignition_delay.initial_states(mech, packed, T0, 2)
    assert y0.shape == (6, 53) and labels == ['row0', 'row1']
    assert np.array_equal(y0[:, 0], np.tile(T0, 2))
    assert not np.array_equal(y0[0, 1:], y0[3, 1:])
    assert (P == 1013250.0).all()


def test_multichip_example_matches_unsharded(capsys):
    """4 virtual shards: the sharded step's J and f equal the unsharded
    ``jacobian_and_dydt`` bit for bit and its norm is JAX's, max|J| +
    max|f|; the chunked ``BatchEvaluator.jacobian_dd`` (2 chunks of 64,
    16 states a shard) equals one unsharded ``SparseJacobian`` call.  It
    prints the JAX script's three lines."""
    out = multichip_batch.main(['--device', 'cpu', '--shards', '4',
                                '--step-states', '16', '--states', '128',
                                '--chunk', '64'])
    text = capsys.readouterr().out
    assert 'mesh devices: 4' in text
    assert 'sharded step: J (64, 53, 53)' in text
    assert 'chunked: 128 states -> J (128, 53, 53), dydt (128, 53)' in text
    packed = out['packed']
    J0, f0 = jacobian_and_dydt(packed, 0.0, torch.as_tensor(out['P']),
                               torch.as_tensor(out['y']))
    assert torch.equal(out['J'], J0) and torch.equal(out['f'], f0)
    assert float(out['norm']) == float(J0.abs().max() + f0.abs().max())
    J1, f1 = SparseJacobian(packed, device='cpu')(out['y_big'],
                                                  out['P_big'])
    assert np.array_equal(out['J_big'], J1.numpy())
    assert np.array_equal(out['f_big'], f1.numpy())


@pytest.mark.parametrize('name', ['ignition_delay', 'multichip_batch'])
def test_example_refuses_to_run_off_the_card_unasked(name):
    """Without ``--device cpu`` an example runs on the card, and raises
    where there is none: it never falls back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    mod = {'ignition_delay': ignition_delay,
           'multichip_batch': multichip_batch}[name]
    with pytest.raises(RuntimeError, match='CUDA'):
        mod.main([])
