"""The port's numpy front end (``pyjac_tpu_torch.core``, ``testers``)
against the JAX package's, and the port's independence from JAX.

The port copies the JAX package's parser, IR and packer (importing
``pyjac_tpu.core`` would import jax), so these tests pin the copies to
their originals field for field.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.core.pack import pack as jpack
from pyjac_tpu.testers import synthetic as jsynth
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import (PackedMechanism, pack,
                                       packed_from_arrays)
from pyjac_tpu_torch.testers import synthetic

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / 'pyjac_tpu_torch'


def _fields(p):
    return {k: getattr(p, k) for k in p.__dataclass_fields__ if k != 'mech'}


def _assert_same_fields(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        va, vb = fa[k], fb[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert np.array_equal(va, vb), k
        else:
            assert type(va) is type(vb) and va == vb, k


@pytest.fixture(scope='module')
def mechs(tmp_path_factory):
    """(JAX packed, port mech, port packed) per mechanism text."""
    from __graft_entry__ import _flagship_packed
    out = {}
    _, jp = _flagship_packed()
    m, p = synthetic.flagship()
    out['flagship'] = (jp, m, p)
    path = tmp_path_factory.mktemp('synth') / 'synth.inp'
    path.write_text(jsynth.synthetic_mechanism(n_species=9, n_reactions=24,
                                               seed=7))
    m = Mechanism.from_files(str(path))
    out['synth'] = (jpack(JMechanism.from_files(str(path))), m, pack(m))
    return out


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_pack_matches_jax(mechs, name):
    jp, m, p = mechs[name]
    _assert_same_fields(p, jp)
    assert m.species_names == jp.mech.species_names
    assert m.fwd_spec_mapping == jp.mech.fwd_spec_mapping


def test_generators_match_jax():
    assert (synthetic.plausible_mechanism(53, 325, seed=42) ==
            jsynth.plausible_mechanism(53, 325, seed=42))
    assert (synthetic.synthetic_mechanism(9, 24, seed=7) ==
            jsynth.synthetic_mechanism(9, 24, seed=7))


@pytest.mark.parametrize('B', [1, 7, 64])
def test_random_states_match_jax(mechs, B):
    # the same batch size on both sides: the first k states of a B-draw
    # differ from a k-draw (several sequential rng calls)
    jp, m, _ = mechs['flagship']
    a = synthetic.random_states(m, B, seed=3)
    b = jsynth.random_states(jp.mech, B, seed=3)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize('name', ['flagship', 'synth'])
def test_packed_from_arrays_round_trip(mechs, name):
    jp, m, p = mechs[name]
    # JAX-side fields -> port dataclass, with the port's own Mechanism
    q = packed_from_arrays(_fields(jp), m)
    assert isinstance(q, PackedMechanism) and q.mech is m
    _assert_same_fields(q, p)
    # the port's own fields round-trip, and own their data
    r = packed_from_arrays(_fields(q), m)
    _assert_same_fields(r, q)
    assert not np.shares_memory(r.nu_net, q.nu_net)


def test_packed_from_arrays_rejects_bad_fields(mechs):
    _, m, p = mechs['synth']
    f = _fields(p)
    missing = dict(f)
    del missing['nu_net']
    with pytest.raises(ValueError, match='nu_net'):
        packed_from_arrays(missing, m)
    with pytest.raises(ValueError, match='bogus'):
        packed_from_arrays(dict(f, bogus=np.zeros(1)), m)
    with pytest.raises(ValueError, match='species'):
        packed_from_arrays(f, mechs['flagship'][1])


# the port's copies of numpy modules of the JAX package: (port file, JAX
# file, how the port's text relates to the original's).  'same': equal;
# 'prefix': the original followed by port-only additions; 'until X': the
# original up to X (what follows is not ported); 'from X': equal from X on
# (what precedes it, the build step, is the port's own)
COPIES = [
    ('core/chemkin.py', 'core/chemkin.py', 'same'),
    ('core/constants.py', 'core/constants.py', 'same'),
    ('core/ir.py', 'core/ir.py', 'same'),
    ('core/mech.py', 'core/mech.py', 'same'),
    ('core/cti.py', 'core/cti.py', 'same'),
    ('core/ctyaml.py', 'core/ctyaml.py', 'same'),
    ('core/ctml.py', 'core/ctml.py', 'same'),
    ('core/pack.py', 'core/pack.py', 'prefix'),
    ('testers/synthetic.py', 'testers/synthetic.py', 'prefix'),
    ('testers/numpy_oracle.py', 'testers/numpy_oracle.py', 'same'),
    ('utils.py', 'utils.py', 'until \n\ndef check_dd_range'),
    ('runtime/__init__.py', 'runtime/__init__.py', 'same'),
    ('runtime/stateio.cpp', 'runtime/stateio.cpp', 'same'),
    ('runtime/stateio.py', 'runtime/stateio.py', 'from def _get_lib():'),
    ('ops/sparse.py', 'ops/sparse.py', 'until def sparse_values('),
]


@pytest.mark.parametrize('port,orig,how', COPIES,
                         ids=[c[0] for c in COPIES])
def test_copied_source_matches_jax(port, orig, how):
    """Each copied module is its original's text, apart from what the
    port adds or leaves out; every import in them is relative, so no
    import path differs."""
    a = (PKG / port).read_text()
    b = (REPO / 'pyjac_tpu' / orig).read_text()
    if how == 'same':
        assert a == b
    elif how == 'prefix':
        assert a.startswith(b) and len(a) > len(b)
    else:
        kind, mark = how.split(' ', 1)
        assert mark in b
        if kind == 'until':
            head = b[:b.index(mark)]
            if port == 'ops/sparse.py':
                # the docstring names the port's own jvp
                head = head.replace(
                    ':func:`pyjac_tpu.ops.jacobian.jacobian_vector_product` '
                    '(a jvp, no\npattern needed)',
                    ':func:`pyjac_tpu_torch.ops.jacobian.'
                    'jacobian_vector_product` (a jvp,\nno pattern needed)')
            assert a.startswith(head)
        else:
            assert mark in a and a[a.index(mark):] == b[b.index(mark):]
    assert not re.search(r'^\s*(import|from)\s+pyjac_tpu\b', a, re.M)


def test_package_sources_import_no_jax():
    """No source file of the port imports jax or the JAX package."""
    bad = re.compile(r'^\s*(import|from)\s+(jax|pyjac_tpu)\b', re.M)
    files = sorted(PKG.rglob('*.py'))
    assert len(files) >= 14
    hits = [(f.name, m.group(0)) for f in files
            for m in bad.finditer(f.read_text())]
    assert not hits, hits


def test_import_loads_no_jax():
    """Importing the port in a fresh interpreter loads neither jax nor
    the JAX package, nor builds or imports any kernel toolchain."""
    code = ('import sys, pyjac_tpu_torch, pyjac_tpu_torch.ops.kernels as k; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "pyjac_tpu", "triton")]; '
            'assert not bad, bad; assert k._lib is None; print("ok")')
    out = subprocess.run([sys.executable, '-c', code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


PORT_MODULES = [
    'pyjac_tpu_torch',
    'pyjac_tpu_torch.__main__',
    'pyjac_tpu_torch.cli',
    'pyjac_tpu_torch.core.chemkin',
    'pyjac_tpu_torch.core.constants',
    'pyjac_tpu_torch.core.ctml',
    'pyjac_tpu_torch.core.cti',
    'pyjac_tpu_torch.core.ctyaml',
    'pyjac_tpu_torch.core.ir',
    'pyjac_tpu_torch.core.mech',
    'pyjac_tpu_torch.core.pack',
    'pyjac_tpu_torch.bench',
    'pyjac_tpu_torch.integrate',
    'pyjac_tpu_torch.ops.common',
    'pyjac_tpu_torch.ops.dydt',
    'pyjac_tpu_torch.ops.jacobian',
    'pyjac_tpu_torch.ops.jacobian_big',
    'pyjac_tpu_torch.ops.jacobian_dense',
    'pyjac_tpu_torch.ops.jacobian_f32',
    'pyjac_tpu_torch.ops.jacobian_sparse',
    'pyjac_tpu_torch.ops.kernels',
    'pyjac_tpu_torch.ops.rates',
    'pyjac_tpu_torch.ops.sparse',
    'pyjac_tpu_torch.ops.thermo',
    'pyjac_tpu_torch.parallel.batch',
    'pyjac_tpu_torch.runtime',
    'pyjac_tpu_torch.runtime.stateio',
    'pyjac_tpu_torch.testers.__main__',
    'pyjac_tpu_torch.testers.functional',
    'pyjac_tpu_torch.testers.numpy_oracle',
    'pyjac_tpu_torch.testers.pasr',
    'pyjac_tpu_torch.testers.performance',
    'pyjac_tpu_torch.testers.synthetic',
    'pyjac_tpu_torch.utils',
]


@pytest.mark.parametrize('name', PORT_MODULES)
def test_port_module_importable(name):
    import importlib
    assert importlib.import_module(name) is not None


def test_port_public_api_complete():
    import pyjac_tpu_torch
    for name in pyjac_tpu_torch.__all__:
        assert hasattr(pyjac_tpu_torch, name), name
    assert re.match(r'^\d+\.\d+\.\d+', pyjac_tpu_torch.__version__)


def test_port_common_helpers_match_jax():
    import jax.numpy as jnp

    from pyjac_tpu.ops import common as jcommon
    from pyjac_tpu_torch.ops import common
    x = np.asarray([0.0, 1e-310, 1.0, 4.0, 7.5])
    for fn in ('safe_log', 'safe_log10'):
        a = getattr(common, fn)(torch.as_tensor(x)).numpy()
        b = np.asarray(getattr(jcommon, fn)(jnp.asarray(x)))
        # the two libms may round a log an ulp apart
        assert np.allclose(a, b, rtol=1e-15, atol=0.0), fn
    for k in range(4):
        a = common.int_pow(torch.as_tensor(x), k).numpy()
        assert np.array_equal(a, np.asarray(jcommon.int_pow(jnp.asarray(x),
                                                             k))), k
    assert common.TINY == jcommon.TINY
