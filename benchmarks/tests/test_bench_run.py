"""Whole runs on the CPU at a test's size (the harness's look for a card
skipped): the result line, the controls and the planted faults coming
out not correct, what a new cell needs, and the command without a
card."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmarks.harness import runner
from benchmarks.harness.cells import HERE, ROOT, load

SMALL = {'batch': 16, 'trace_calls': 2}
EVAL = ['gri30-eval-B131072', 'usc2-eval-B32768', 'gri30-f32-eval-B262144']


def run(cell, seed=2**31 + 99, trace=False, control=False, seconds=0.2):
    return runner.run_cell(load(cell), seed, seconds, trace, 'cpu',
                           control=control, overrides=SMALL)


@pytest.mark.parametrize('cell', EVAL + ['gri30-integrate-B32768'])
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out['correct'] and out['failed'] == 0
    assert list(out)[-1] == 'checks'
    spec = load(cell)
    assert set(out['metrics']) == {m['name'] for m in spec.end_to_end}
    assert all(v['value'] > 0 for v in out['metrics'].values())


@pytest.mark.parametrize('cell', EVAL + ['gri30-integrate-B32768'])
def test_control_is_not_correct(cell):
    out = run(cell, control=True)
    assert not out['correct']


def _alter_one_answer(mod_cls, monkeypatch):
    """A state's answer altered where it is produced: state 0 gets state
    1's J and f."""
    call = mod_cls.call_tr

    def bad(self, y_t, P_t):
        out = call(self, y_t, P_t)
        for x in out:
            x[..., 0] = x[..., 1]
        return out
    monkeypatch.setattr(mod_cls, 'call_tr', bad)


def _half_left_out(mod_cls, monkeypatch):
    """Half of the batch left out: the call computes the first half and
    returns nothing computed for the rest."""
    call = mod_cls.call_tr

    def bad(self, y_t, P_t):
        h = y_t.shape[1] // 2
        half = call(self, y_t[:, :h].contiguous(), P_t[:, :h].contiguous())
        return tuple(torch.cat([x, torch.zeros_like(x)], -1) for x in half)
    monkeypatch.setattr(mod_cls, 'call_tr', bad)


@pytest.mark.parametrize('fault', [_alter_one_answer, _half_left_out])
@pytest.mark.parametrize('cell', EVAL)
def test_eval_faults_are_not_correct(cell, fault, monkeypatch):
    from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian
    from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian
    fault(F32Jacobian if 'f32' in cell else SparseJacobian, monkeypatch)
    assert not run(cell)['correct']


def test_integrate_step_unchanged_is_not_correct(monkeypatch):
    """Every step returns its state unchanged: the stage solves give
    zero, so each step is accepted with y_new = y."""
    import importlib

    # the module (the package exports the function under its name)
    integ = importlib.import_module('pyjac_tpu_torch.integrate')
    monkeypatch.setattr(integ, 'lu_solve',
                        lambda fac, rhs: torch.zeros_like(rhs))
    assert not run('gri30-integrate-B32768')['correct']


def test_integrate_answer_altered_is_not_correct(monkeypatch):
    """One state's final temperature altered by 0.1 K where the result
    is produced."""
    import pyjac_tpu_torch
    integrate = pyjac_tpu_torch.integrate

    def bad(*a, **k):
        res = integrate(*a, **k)
        res.y[0, 0] += 0.1
        return res
    monkeypatch.setattr(pyjac_tpu_torch, 'integrate', bad)
    assert not run('gri30-integrate-B32768')['correct']


@pytest.mark.parametrize('cell', ['gri30-eval-B131072',
                                  'gri30-integrate-B32768'])
def test_traced_run_reads_the_trace(cell):
    out = run(cell, trace=True)
    assert out['correct']
    assert {'busy_s', 'window_s'} <= set(out['device'])
    assert out['device']['window_s'] > 0
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    # on the CPU no device record exists: the device metrics are left out
    names = set(out['metrics'])
    assert not names & {'stage_a_ms', 'jacobian_roofline',
                        'device_idle.eval', 'device_idle.integrate'}


def test_new_files_are_found_by_name(tmp_path, env):
    """A configuration, a traffic mix, a metric and a cell added as new
    files, with no file of the benchmark edited."""
    shutil.copytree(HERE, tmp_path / 'benchmarks',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    spec = json.loads((ROOT / 'BENCHMARK.json').read_text())
    b = tmp_path / 'benchmarks'
    cfg = json.loads((b / 'configs' / 'gri30-class.json').read_text())
    cfg.update(name='small-class', n_species=12, n_reactions=30,
               args={'n_species': 12, 'n_reactions': 30, 'seed': 3})
    (b / 'configs' / 'small-class.json').write_text(json.dumps(cfg))
    tr = json.loads((b / 'traffic' / 'random-eval-B32768.json').read_text())
    tr['batch'] = 8
    (b / 'traffic' / 'random-eval-B8.json').write_text(json.dumps(tr))
    (b / 'limits' / 'small-eval-B8.json').write_text(
        (b / 'limits' / 'usc2-eval-B32768.json').read_text())
    (b / 'metrics' / 'states_per_call.py').write_text(
        'def read(run):\n    return run.states_per_call\n')
    spec['configs'].append(dict(spec['configs'][1], name='small-class',
                                file='benchmarks/configs/small-class.json'))
    spec['workloads'].append({'name': 'small-eval-B8',
                              'config': 'small-class',
                              'traffic': 'random-eval-B8', 'chips': 1,
                              'why': 'a test'})
    spec['end_to_end'].append({'name': 'states_per_call', 'unit': 'states',
                               'better': 'higher', 'bound': 0.01,
                               'source': 'host_clock',
                               'workloads': ['small-eval-B8']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    env['PYTHONPATH'] = '%s:%s' % (tmp_path, ROOT)
    code = ('import json\n'
            'from benchmarks.harness import cells, runner\n'
            'c = cells.load("small-eval-B8")\n'
            'print(json.dumps(runner.run_cell(c, 5, 0.1, False, "cpu")))\n')
    p = subprocess.run([sys.executable, '-c', code], cwd=tmp_path, env=env,
                       text=True, capture_output=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out['correct']
    assert out['metrics']['states_per_call']['value'] == 8
    # the metrics that list their cells do not name the new one
    assert set(out['metrics']) == {'states_per_call', 'setup_s'}


def test_run_holds_no_forbidden_module(env):
    code = ('from benchmarks.harness import cells, runner\n'
            'runner.run_cell(cells.load("gri30-integrate-B32768"), 3, 0.1,'
            ' False, "cpu", overrides={"batch": 8})\n'
            'runner.run_cell(cells.load("gri30-eval-B131072"), 3, 0.1,'
            ' True, "cpu", overrides={"batch": 8, "trace_calls": 1})\n'
            'import sys\n'
            'print(sorted({k.split(".")[0] for k in sys.modules}))\n'
            'print(runner.forbidden_modules())\n')
    p = subprocess.run([sys.executable, '-c', code], env=env, text=True,
                       capture_output=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    top, found = p.stdout.strip().splitlines()[-2:]
    assert found == '[]'
    assert 'pyjac_tpu_torch' in eval(top)
    assert not set(eval(top)) & {'jax', 'jaxlib', 'flax', 'pyjac_tpu',
                                 'bench'}


def _command(cwd, env):
    return subprocess.run(
        [sys.executable, 'benchmarks/run.py', '--workload',
         'gri30-eval-B131072', '--seed', '3', '--seconds', '1', '--trace',
         '0'], cwd=cwd, env=env, text=True, capture_output=True,
        timeout=300)


def test_command_without_card_prints_no_result(no_card, env):
    p = _command(ROOT, env)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_command_alone_prints_no_result(tmp_path, env):
    """In a directory that holds only BENCHMARK.json and the
    benchmark's files, the program is missing: no result."""
    shutil.copytree(HERE, tmp_path / 'benchmarks',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    env.pop('PYTHONPATH')
    p = _command(tmp_path, env)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.cuda
@pytest.mark.parametrize('cell', EVAL + ['gri30-integrate-B32768'])
def test_card_cell_is_correct(cell, card, env):
    """On the card: one short run of each cell, correct."""
    p = subprocess.run(
        [sys.executable, 'benchmarks/run.py', '--workload', cell, '--seed',
         '2200000777', '--seconds', '3', '--trace', '0'], cwd=ROOT, env=env,
        text=True, capture_output=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])['correct']
