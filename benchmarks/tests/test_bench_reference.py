"""The plain reference agrees with the program's plain float64
Jacobian and dy/dt; the reference itself loads nothing of the
program."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks.harness import compare, inputs
from benchmarks.harness.cells import load, module


@pytest.mark.parametrize('cell', ['gri30-eval-B131072', 'usc2-eval-B32768'])
def test_reference_is_the_programs_plain_jacobian(cell):
    from pyjac_tpu_torch.ops.jacobian import eval_jacobian
    from pyjac_tpu_torch.ops.dydt import dydt
    from pyjac_tpu_torch.testers.synthetic import packed_from_text
    c = load(cell)
    text = inputs.mechanism_text(c.config)
    ref = module('reference', c.config['reference'])
    m = ref.Mechanism(text)
    _, packed = packed_from_text(text)
    st = inputs.draw_states(c.config, dict(c.traffic, batch=16), 5)
    y, P = torch.as_tensor(st.y), torch.as_tensor(st.P)
    t = m.tensors('cpu')
    Jr, fr = ref.jacobian(t, y, P)
    Jp = eval_jacobian(packed, 0.0, P, y)
    fp = dydt(packed, 0.0, P, y)
    assert float(compare._jac_err(Jp, Jr).max()) < 1e-12
    sc = ref.dydt_scale(t, y, P)
    assert float(((fp - fr).abs() / sc).max()) < 1e-12


def test_reference_loads_nothing_of_the_program(env):
    code = (
        'import sys, torch\n'
        'from benchmarks.harness import inputs\n'
        'from benchmarks.harness.cells import load, module\n'
        'c = load("gri30-eval-B131072")\n'
        'ref = module("reference", c.config["reference"])\n'
        'm = ref.Mechanism(inputs.mechanism_text(c.config))\n'
        'st = inputs.draw_states(c.config, dict(c.traffic, batch=4), 1)\n'
        'ref.jacobian(m.tensors("cpu"), torch.as_tensor(st.y),'
        ' torch.as_tensor(st.P))\n'
        'print(sorted({k.split(".")[0] for k in sys.modules}))\n')
    out = subprocess.run([sys.executable, '-c', code], env=env, text=True,
                         capture_output=True, check=True).stdout
    top = set(eval(out.strip().splitlines()[-1]))
    assert not top & {'pyjac_tpu_torch', 'pyjac_tpu', 'jax', 'jaxlib',
                      'flax', 'bench'}


def test_float32_reference_keeps_float32():
    c = load('gri30-eval-B131072')
    ref = module('reference', 'chemkin_conp')
    m = ref.Mechanism(inputs.mechanism_text(c.config))
    st = inputs.draw_states(c.config, dict(c.traffic, batch=4), 1)
    for tf32 in (False, True):
        t = m.tensors('cpu', torch.float32, tf32)
        J, f = ref.jacobian(t, torch.as_tensor(st.y).float(),
                            torch.as_tensor(st.P).float())
        assert J.dtype == f.dtype == torch.float32
        assert np.isfinite(J.numpy()).all()
