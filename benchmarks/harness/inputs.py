"""A cell's inputs, made from ``--seed``: the mechanism text of its
configuration and the batch of states of its traffic mix.

The traffic file's ``states`` says how states are drawn:

* ``{"draw": "pasr", "file": "data/<name>.npz"}``: the file's ``y``
  (n, N) and ``P`` (n,) rows tiled to ``batch`` states (the first
  ``batch mod n`` rows once more), in an order drawn from the seed;
* ``{"draw": "random", "T_range": [lo, hi], "P_range": [lo, hi]}``: the
  configuration's generator's ``random_states`` at ``batch`` states.

Every seed gives the same number of states of the same kind (from a
file, the same states in another order), so the work of a call does not
depend on the seed.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass

import numpy as np

from .cells import HERE, ROOT, module


def mechanism_text(config: dict) -> str:
    """The configuration's Chemkin text, from its frozen generator."""
    return module('generators', config['generator']).generate(
        **config['args'])


def mechanism_file(config: dict, text: str) -> pathlib.Path:
    """Write ``text`` where the program's front end reads it: a fixed
    path inside the checkout, one file a configuration."""
    path = ROOT / 'build' / 'benchmarks' / (config['name'] + '.inp')
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.is_file() or path.read_text() != text:
        tmp = path.with_suffix('.inp.tmp')
        tmp.write_text(text)
        tmp.replace(path)
    return path


@dataclass
class States:
    """``pool_y`` (U, N) and ``pool_P`` (U,) float64 rows and ``idx``
    (B,): state b of the batch is pool row ``idx[b]``."""
    pool_y: np.ndarray
    pool_P: np.ndarray
    idx: np.ndarray

    @property
    def y(self) -> np.ndarray:
        return self.pool_y[self.idx]

    @property
    def P(self) -> np.ndarray:
        return self.pool_P[self.idx]


def draw_states(config: dict, traffic: dict, seed: int) -> States:
    spec = traffic['states']
    B = int(traffic['batch'])
    rng_seed = int(seed)
    if spec['draw'] == 'pasr':
        d = np.load(HERE / spec['file'])
        y, P = np.asarray(d['y'], np.float64), np.asarray(d['P'], np.float64)
        if y.shape[1] != config['n_species']:
            raise ValueError('%s holds states of %d species, the '
                             'configuration has %d' % (
                                 spec['file'], y.shape[1],
                                 config['n_species']))
        idx = np.random.default_rng(rng_seed).permutation(
            np.arange(B) % len(y))
        return States(y, P, idx)
    if spec['draw'] == 'random':
        gen = module('generators', config['generator'])
        y, P = gen.random_states(config['n_species'], B, seed=rng_seed,
                                 T_range=tuple(spec['T_range']),
                                 P_range=tuple(spec['P_range']))
        return States(y, P, np.arange(B))
    raise ValueError('unknown state draw %r' % spec['draw'])
