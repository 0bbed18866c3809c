"""The benchmark's frozen generator and state draws reproduce the
program's today, and every seed draws the same work."""

import numpy as np
import pytest

from benchmarks.harness import inputs
from benchmarks.harness.cells import load, module


@pytest.mark.parametrize('cell', ['gri30-eval-B131072', 'usc2-eval-B32768'])
def test_frozen_generator_is_the_programs(cell):
    from pyjac_tpu_torch.testers.synthetic import (packed_from_text,
                                                   plausible_mechanism,
                                                   random_states)
    cfg = load(cell).config
    text = inputs.mechanism_text(cfg)
    assert text == plausible_mechanism(**cfg['args'])
    mech, _ = packed_from_text(text)
    gen = module('generators', cfg['generator'])
    for seed in (0, 3, 2**31 + 12345):
        y, P = gen.random_states(cfg['n_species'], 64, seed=seed,
                                 T_range=(1500.0, 2500.0))
        y2, _, P2 = random_states(mech, 64, seed=seed,
                                  T_range=(1500.0, 2500.0))
        assert np.array_equal(y, y2) and np.array_equal(P, P2)


def test_pasr_states_are_the_repositorys():
    import pathlib
    d = np.load(pathlib.Path(inputs.ROOT) / 'tests' / 'data' /
                'flagship_states.npz')
    f = np.load(inputs.HERE / 'data' / 'pasr_gri30_class.npz')
    assert np.array_equal(d['y'], f['y']) and np.array_equal(d['P'], f['P'])


@pytest.mark.parametrize('cell', ['gri30-eval-B131072',
                                  'gri30-integrate-B32768',
                                  'gri30-f32-eval-B262144'])
def test_seeds_draw_the_same_work(cell):
    c = load(cell)
    tr = dict(c.traffic, batch=9000)
    a = inputs.draw_states(c.config, tr, 1)
    b = inputs.draw_states(c.config, tr, 2**33 + 7)
    assert a.y.shape == b.y.shape == (9000, c.config['n_species'])
    if tr['states']['draw'] == 'pasr':
        # the same states, in another order
        assert np.array_equal(np.sort(a.idx), np.sort(b.idx))
        assert not np.array_equal(a.idx, b.idx)
    again = inputs.draw_states(c.config, tr, 2**33 + 7)
    assert np.array_equal(again.y, b.y) and np.array_equal(again.P, b.P)
