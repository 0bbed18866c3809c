"""The port's testers against the JAX package's: the functional (parity)
tester, the performance sweep, the PaSR generator and the functional
tester's command line, on the same numpy inputs (the port on the CPU:
its kernels' plain versions)."""

import os
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

from pyjac_tpu.core.mech import Mechanism as JMechanism
from pyjac_tpu.testers import functional as jfunctional
from pyjac_tpu.testers import pasr as jpasr
from pyjac_tpu.testers import performance as jperformance
from pyjac_tpu_torch.core.mech import Mechanism
from pyjac_tpu_torch.core.pack import pack
from pyjac_tpu_torch.integrate import integrate
from pyjac_tpu_torch.ops.jacobian import eval_jacobian
from pyjac_tpu_torch.testers import functional, pasr, performance
from pyjac_tpu_torch.testers import synthetic
from pyjac_tpu_torch.testers.__main__ import main as functional_cli

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent

# error_arrays keys and how the port's reading must agree with the JAX
# package's on the same states.  Each side compares its own evaluations
# with the same oracles, so the two readings are two realisations of f64
# roundoff (flagship, 64 PaSR states: port / JAX worst state):
# - at roundoff on both sides, every state <= 1e-12: the loop oracle's
#   concentrations, rates, pressure modifications and species rates
#   (<= 4.6e-14 / 4.7e-14), the whole-matrix norm of J against AD
#   (7.6e-15 / 1.9e-15) and the zero-entry norms;
# - the finite-difference Jacobian (norm relative, each side's FD of its
#   own dy/dt): every state |port - jax| <= 1e-3 x jax + 1e-11;
# - set by entries that cancel up to 1e7-fold (dy/dt rows near
#   equilibrium) or 1e14-fold (J entries against their row, AD): the
#   worst states' readings within 4x of each other (dy/dt 1.878e-2 /
#   1.878e-2; J thresholded max 6.8e-7 / 4.0e-7, L2 over nonzero entries
#   3.0e-5 / 1.2e-5).
ABS_KEYS = ('err_conc', 'err_fwd', 'err_rev', 'err_pres_mod',
            'err_spec_rates', 'err_dydt_zero', 'err_jac_norm',
            'err_jac_zero')
RATIO_KEYS = ('err_dydt', 'err_jac', 'err_jac_max', 'err_jac_thr',
              'err_jac_thr_max')


def _states(mech, y, P):
    """(t, T, P, Y original order) rows of pivoted states."""
    Y = np.concatenate([y[:, 1:], 1.0 - y[:, 1:].sum(1, keepdims=True)], 1)
    return np.concatenate([np.zeros((len(y), 1)), y[:, :1], P[:, None],
                           Y[:, np.asarray(mech.back_spec_mapping)]], 1)


def _assert_errors_agree(port, jax):
    assert sorted(port) == sorted(jax)
    for k in port:
        a, b = port[k], jax[k]
        assert a.shape == b.shape and np.isfinite(a).all(), k
        if k in ABS_KEYS:
            assert np.abs(a).max() <= 1e-12 and np.abs(b).max() <= 1e-12, k
        elif k == 'err_jac_fd':
            assert (np.abs(a - b) <= 1e-3 * np.abs(b) + 1e-11).all(), k
        else:
            assert k in RATIO_KEYS
            assert b.max() / 4 <= a.max() <= 4 * b.max(), (k, a.max(),
                                                            b.max())


@pytest.fixture(scope='module')
def flagship_rows():
    m, p = synthetic.flagship()
    d = np.load(REPO / 'tests' / 'data' / 'flagship_states.npz')
    return m, p, _states(m, d['y'], d['P'])


def test_functional_matches_jax_and_pins_gate(flagship_rows, tmp_path,
                                              capsys):
    """The functional tester on the 64 flagship PaSR states that
    ``-n 64`` selects: every error_arrays key agrees with the JAX
    package's, and chip_smoke.py's record of JAX's readings and its gate
    (twice JAX's thresholded reading) hold."""
    import chip_smoke
    from __graft_entry__ import _flagship_packed

    m, p, rows = flagship_rows
    jm, jp = _flagship_packed()
    out = tmp_path / 'error_arrays.npz'
    got = functional.run_functional_test(m, p, rows, num_states=64,
                                         out_file=str(out), verbose=False,
                                         device='cpu')
    want = jfunctional.run_functional_test(jm, jp, rows, num_states=64,
                                           out_file=None, verbose=False)
    with capsys.disabled():
        print('\nflagship, 64 PaSR states, CPU: key jax port')
        for k in sorted(want):
            print('  %-16s %.4e %.4e' % (k, want[k].max(), got[k].max()))
    _assert_errors_agree(got, want)
    saved = np.load(out)
    assert sorted(saved.files) == sorted(want)
    assert all(np.array_equal(saved[k], got[k]) for k in got)
    # the JAX readings chip_smoke.py prints beside the card's, and its
    # gate, twice JAX's thresholded reading; each is set by roundoff on
    # cancelled entries, which XLA:CPU's vector width can move, so the pin
    # holds each within 1.25x of this host's reading
    for k, v in chip_smoke.FUNCTIONAL_JAX_CPU.items():
        assert v / 1.25 <= want[k].max() <= 1.25 * v, (k, want[k].max(), v)
    assert chip_smoke.TOL_FUNCTIONAL == \
        2 * chip_smoke.FUNCTIONAL_JAX_CPU['err_jac_thr_max']
    # the port's own reading on these states passes the card's gate with
    # 10% of it to spare (read 6.814e-7 against 8.003e-7)
    assert got['err_jac_thr_max'].max() <= 0.9 * chip_smoke.TOL_FUNCTIONAL


@pytest.fixture(scope='module')
def small(tmp_path_factory):
    """A small plausible mechanism's file, parsed by both packages, and
    four of its random states as PaSR rows."""
    path = tmp_path_factory.mktemp('small') / 'small.inp'
    path.write_text(synthetic.plausible_mechanism(12, 30, seed=4))
    m = Mechanism.from_files(str(path))
    y, T, P = synthetic.random_states(m, 4, seed=0)
    return str(path), m, JMechanism.from_files(str(path)), _states(m, y, P)


def test_functional_matches_jax_conv(small):
    _, m, jm, rows = small
    got = functional.run_functional_test(m, None, rows, conp=False,
                                         fd_order=2, out_file=None,
                                         verbose=False, device='cpu')
    want = jfunctional.run_functional_test(jm, None, rows, conp=False,
                                           fd_order=2, out_file=None,
                                           verbose=False)
    _assert_errors_agree(got, want)


@pytest.mark.parametrize('order', [1, 2, 4, 6])
def test_fd_jacobian_matches_analytical(small, order):
    """Each finite-difference order approximates the closed-form J, more
    closely with the order (one state, on which no FD step meets a
    cancelled entry; returned as (N, N) on the input's device)."""
    _, m, _, rows = small
    p = pack(m)
    y = torch.as_tensor(np.concatenate([rows[2:3, 1:2],
                                        rows[2:3, 3:][:, m.fwd_spec_mapping]
                                        [:, :-1]], 1))[0]
    P = torch.as_tensor(rows[2, 2])
    J = eval_jacobian(p, 0.0, P, y)
    Jfd = functional.fd_jacobian(p, 0.0, P, y, order=order)
    assert Jfd.shape == J.shape and Jfd.dtype == torch.float64
    err = float(torch.linalg.norm(Jfd - J) / torch.linalg.norm(J))
    assert err < {1: 1e-4, 2: 1e-7, 4: 1e-9, 6: 1e-9}[order], err


def test_functional_cli(small, tmp_path, capsys):
    """``python -m pyjac_tpu_torch.testers``: random states, the gate,
    ``-cn`` and ``-or``."""
    path = small[0]
    out = str(tmp_path / 'e.npz')
    base = ['-i', path, '--device', 'cpu', '-o', out]
    assert functional_cli(base + ['-n', '4']) == 0
    assert 'PASS' in capsys.readouterr().out
    assert len(np.load(out)['err_jac']) == 4
    assert functional_cli(base + ['-n', '4', '--fail-above', '0']) == 1
    assert 'FAIL' in capsys.readouterr().err
    assert functional_cli(base + ['-cn', '0,2']) == 0
    assert len(np.load(out)['err_jac']) == 2
    assert functional_cli(base + ['-n', '2', '-or', '0,1,2,3']) == 0


def test_entry_points_need_a_card_unless_asked(small, tmp_path):
    """The testers run on the card unless the caller asks for the CPU;
    without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    path, m, _, rows = small
    with pytest.raises(RuntimeError, match='no CUDA device'):
        functional.run_functional_test(m, None, rows, out_file=None)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        performance.performance_tester(str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pasr.run_simulation(m, 'premixed', 1000.0, 1.0, 1.0, {}, {},
                            inlet_X=np.ones(m.n_species))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        functional_cli(['-i', path, '-n', '2'])


# ---------------------------------------------------------------------------
# the performance sweep
# ---------------------------------------------------------------------------

def test_step_sizes_and_step_file_match_jax(tmp_path):
    for total in (1, 256, 300, 1024, 4032):
        for lo in (1, 64, 256):
            assert (performance.step_sizes(total, lo) ==
                    jperformance.step_sizes(total, lo))
    f = tmp_path / 'out.txt'
    f.write_text('256,1.5\n256,2.5\nbad line\n512,x\n512,3\n1,2,3\n\n'
                 '1024,4.0\n')
    assert (performance.check_step_file(str(f), 10) ==
            jperformance.check_step_file(str(f), 10) ==
            {256: 2, 512: 1, 1024: 1})
    assert performance.check_step_file(str(tmp_path / 'none'), 1) == {}
    assert (performance.PerfConfig('m', 'dd-sparse', 'f64', 0).filename ==
            jperformance.PerfConfig('m', 'dd-sparse', 'f64', 0).filename)


@pytest.fixture(scope='module')
def work(tmp_path_factory, small):
    """A work directory with one mechanism folder: the small mechanism
    and 40 PaSR-layout rows."""
    path, m, _, _ = small
    d = tmp_path_factory.mktemp('work')
    os.makedirs(d / 'small')
    shutil.copy(path, d / 'small' / 'small.inp')
    y, T, P = synthetic.random_states(m, 40, seed=1)
    np.save(d / 'small' / 'states.npy', _states(m, y, P))
    return d


def _lines(path):
    with open(path) as fh:
        return [ln.split(',') for ln in fh.read().splitlines()]


def test_sweep_writes_what_jax_writes(work, tmp_path, monkeypatch):
    """The port's sweep over the plain and kernel methods (their plain
    versions on the CPU) writes the files and lines the JAX package's
    ``ajac`` sweep writes for the same directory, and the same
    ``data.bin`` (the JAX side through its state I/O's NumPy fallback:
    its native build writes next to its source, which the JAX package's
    own tests do)."""
    from pyjac_tpu.runtime import stateio as jstateio
    monkeypatch.setattr(jstateio, '_lib', None)
    monkeypatch.setattr(jstateio, '_lib_tried', True)
    jdir, pdir = tmp_path / 'jax', tmp_path / 'port'
    shutil.copytree(work, jdir)
    shutil.copytree(work, pdir)
    steps, reps = [16, 40], 2
    jperformance.performance_tester(str(jdir), methods=['ajac'],
                                    repeats=reps, steps=steps, verbose=False)
    methods = ['ajac', 'dd', 'dd-sparse', 'pallas']
    performance.performance_tester(str(pdir), methods=methods, repeats=reps,
                                   steps=steps, verbose=False, device='cpu')
    jfiles = sorted(os.listdir(jdir / 'output'))
    pfiles = sorted(os.listdir(pdir / 'output'))
    assert jfiles == ['small_ajac_f64_output.txt']
    # each file named by the precision its method computes in: 'pallas'
    # (K3) in float32, the others in float64
    assert pfiles == sorted(['small_ajac_f64_output.txt',
                             'small_dd_f64_output.txt',
                             'small_dd-sparse_f64_output.txt',
                             'small_pallas_f32_output.txt'])
    want = [n for n, _ in _lines(jdir / 'output' / jfiles[0])]
    assert want == ['16', '16', '40', '40']
    for fn in pfiles:
        got = _lines(pdir / 'output' / fn)
        assert [n for n, _ in got] == want, fn
        assert all(float(ms) > 0 for _, ms in got), fn
    assert ((jdir / 'small' / 'data.bin').read_bytes() ==
            (pdir / 'small' / 'data.bin').read_bytes())


def test_sweep_resumes(work, tmp_path):
    """A second call appends nothing; a file one line short gets that
    line, and the rest of the matrix is skipped."""
    d = tmp_path / 'w'
    shutil.copytree(work, d)
    kw = dict(methods=['ajac', 'fd'], repeats=2, steps=[8, 16],
              verbose=False, device='cpu')
    performance.performance_tester(str(d), **kw)
    out = d / 'output'
    before = {f: (out / f).read_text() for f in os.listdir(out)}
    performance.performance_tester(str(d), **kw)
    assert {f: (out / f).read_text() for f in os.listdir(out)} == before
    f = out / 'small_ajac_f64_output.txt'
    f.write_text(''.join(before[f.name].splitlines(True)[:3]))
    performance.performance_tester(str(d), **kw)
    assert performance.check_step_file(str(f), 2) == {8: 2, 16: 2}
    assert (out / 'small_fd_f64_output.txt').read_text() == \
        before['small_fd_f64_output.txt']


def test_sweep_refuses_float32_plain_methods(work, tmp_path):
    """ajac / ad / fd run the port's float64 ops: asked for f32 the sweep
    refuses before it writes anything."""
    d = tmp_path / 'w'
    shutil.copytree(work, d)
    with pytest.raises(NotImplementedError, match=r'ajac \(f64\).*float32'):
        performance.performance_tester(str(d), methods=['ajac'],
                                       dtypes=['f32'], steps=[8],
                                       device='cpu')
    assert not (d / 'output').exists() or not os.listdir(d / 'output')


@pytest.mark.parametrize('methods, dtypes, refused', [
    (['pallas'], ['f64'], 'pallas (f32)'),
    (['dd'], ['f32'], 'dd (f64)'),
    (['dd-sparse', 'pallas'], ['f64'], 'pallas (f32)'),
    (['pallas'], ['f32'], None),
    (['dd-sparse', 'dd'], ['f64'], None)])
def test_sweep_precision_follows_the_method(work, tmp_path, methods,
                                            dtypes, refused):
    """A precision a method does not compute in is refused before
    anything is written; the method's own precision, asked for, writes
    the file that the default writes."""
    d = tmp_path / 'w'
    shutil.copytree(work, d)
    kw = dict(methods=methods, dtypes=dtypes, steps=[8], repeats=1,
              verbose=False, device='cpu')
    if refused:
        with pytest.raises(NotImplementedError, match=re.escape(refused)):
            performance.performance_tester(str(d), **kw)
        assert not (d / 'output').exists() or not os.listdir(d / 'output')
        return
    performance.performance_tester(str(d), **kw)
    assert sorted(os.listdir(d / 'output')) == sorted(
        'small_%s_%s_output.txt' % (m, performance.method_precision(m))
        for m in methods)


# ---------------------------------------------------------------------------
# the PaSR generator
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def pasr_case(tmp_path_factory):
    """An 8-species plausible mechanism (port and JAX), its inlet mole
    fractions and a pilot relaxed with the port's integrator."""
    text = synthetic.plausible_mechanism(8, 16, seed=5)
    path = tmp_path_factory.mktemp('pasr') / 'm.inp'
    path.write_text(text)
    mech, packed = synthetic.packed_from_text(text)
    names = list(mech.species_names)
    rng = np.random.default_rng(7)
    X = np.zeros(packed.n_species)
    for i in [i for i, nm in enumerate(names) if nm != 'N2'][:4]:
        X[i] = rng.uniform(0.05, 0.15)
    X[names.index('N2')] = 1.0 - X.sum()
    X /= X.sum()
    Y = pasr.mole_to_mass_fracs(packed, X)
    y0 = np.concatenate([[1900.0], Y[np.asarray(mech.fwd_spec_mapping)]
                         [:-1]])[None]
    r = integrate(packed, torch.as_tensor(y0), torch.as_tensor([1013250.0]),
                  1e-6, rtol=1e-3, atol=1e-12, device='cpu')
    y1 = r.y.numpy()[0]
    pilot = (float(y1[0]), np.concatenate([y1[1:], [1.0 - y1[1:].sum()]]))
    return mech, packed, JMechanism.from_files(str(path)), X, pilot


def test_run_simulation_matches_jax(pasr_case):
    """Two particles over one residence time (ten steps, scipy's BDF on
    each side's dy/dt and Jacobian at rtol 1e-9): the same frames, times
    and pressures; temperatures to 1e-9 relative and mass fractions to
    1e-9, the BDF's own tolerance."""
    mech, _, jmech, X, pilot = pasr_case
    kw = dict(case='premixed', init_temp=1000.0, pres=10.0, eq_ratio=1.0,
              fuel={}, oxidizer={}, num_part=2, tau_res=1e-5, tau_mix=1e-2,
              tau_pair=1e-3, num_res=1, seed=3, verbose=False, inlet_X=X,
              pilot=pilot)
    got = pasr.run_simulation(mech, device='cpu', **kw)
    want = jpasr.run_simulation(jmech, **kw)
    assert got.shape == want.shape == (11, 2, 3 + mech.n_species)
    assert np.array_equal(got[..., 0], want[..., 0])
    assert np.array_equal(got[..., 2], want[..., 2])
    assert np.isfinite(got).all()
    assert (np.abs(got[..., 1] - want[..., 1]) <= 1e-9 * want[..., 1]).all()
    assert np.abs(got[..., 3:] - want[..., 3:]).max() <= 1e-9


def test_reaction_substep_integrator_matches_bdf(pasr_case):
    """The substep through the port's integrator (taken on its own once
    particles x species > 1024) agrees with scipy's BDF to the
    integrators' tolerances."""
    mech, packed, _, _, pilot = pasr_case
    chem = pasr._Chemistry(packed, 1013250.0, 'cpu')
    T, Y = pilot
    row = np.concatenate([[pasr._enthalpy(packed, T, Y), T], Y])
    parts = np.stack([row, row])
    parts[1, 2:] = 0.5 * (Y + pasr.mole_to_mass_fracs(
        packed, np.full(packed.n_species, 1.0 / packed.n_species)))
    parts[1, 0] = pasr._enthalpy(packed, T, parts[1, 2:])
    a = pasr.reaction_substep(chem, parts, 1e-7, use_framework=True)
    b = pasr.reaction_substep(chem, parts, 1e-7, use_framework=False)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert np.abs(a[:, 1] - b[:, 1]).max() <= 1e-5 * b[:, 1].max()
    assert np.abs(a[:, 2:] - b[:, 2:]).max() <= 1e-6


def test_parse_input_file_matches_jax(tmp_path):
    f = tmp_path / 'pasr.yaml'
    f.write_text('case: premixed\ntemperature: 400\npressure: 1.0\n'
                 'equivalence ratio: 1.0\nfuel:\n  H2: 1.0\noxidizer:\n'
                 '  O2: 1.0\n  N2: 3.76\ncomplete products:\n  - H2O\n'
                 '  - N2\nnumber of particles: 10\nresidence time: 10.e-3\n'
                 'mixing time: 1.e-3\npairing time: 1.e-3\n'
                 'number of residence times: 5\n')
    assert pasr.parse_input_file(str(f)) == jpasr.parse_input_file(str(f))
