"""Fixtures of the benchmark's own tests (run them from the repository
root: ``python -m pytest benchmarks/tests``).  Tests that need the
card are marked ``cuda`` and ask for the ``card`` fixture, which
decides when the test runs, never when the module is imported."""

import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a card')


@pytest.fixture
def env():
    """The environment of a subprocess that imports the repository."""
    e = dict(os.environ)
    e['PYTHONPATH'] = str(ROOT)
    return e
