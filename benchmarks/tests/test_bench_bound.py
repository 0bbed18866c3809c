"""The bound arithmetic: exact bytes, and the program's closed-form
operation count worked out from the benchmark's own parse."""

import pytest

from benchmarks.harness import bound, inputs
from benchmarks.harness.cells import load, module

OPS = {'gri30-class': 77208.0, 'usc2-class': 231456.0}


@pytest.mark.parametrize('cell', ['gri30-eval-B131072', 'usc2-eval-B32768'])
def test_operations_are_the_programs(cell):
    from pyjac_tpu_torch.ops.jacobian_dense import DenseJacobian
    from pyjac_tpu_torch.profiling import dense_ops
    from pyjac_tpu_torch.testers.synthetic import packed_from_text
    cfg = load(cell).config
    text = inputs.mechanism_text(cfg)
    m = module('reference', cfg['reference']).Mechanism(text)
    _, packed = packed_from_text(text)
    assert bound.ops_per_state(m) == OPS[cfg['name']]
    assert dense_ops(DenseJacobian(packed, device='cpu'), 1) == OPS[
        cfg['name']]


def test_bytes_are_exact():
    cfg = load('gri30-eval-B131072').config
    m = module('reference', 'chemkin_conp').Mechanism(
        inputs.mechanism_text(cfg))
    N = 53
    coef = bound.coefficients(m)
    # 16 numbers a species, 3 a reaction, the stoichiometric entries,
    # LOW and Troe of the falloff rows, the non-unit efficiencies
    eff = int(((m.eff != 1.0) & (m.thd | m.fall)[:, None]).sum())
    assert coef == (16 * N + 3 * m.R + int((m.nu_f > 0).sum()) +
                    int((m.nu_r > 0).sum()) + 3 * int(m.fall.sum()) +
                    int((m.troe * (3 + m.troe_T2)).sum()) + eff)
    for dtype, item in (('float64', 8), ('float32', 4)):
        b = bound.jacobian_bound(m, 131072, dtype)
        assert b['bytes'] == item * (2 * N + 1 + N * N) * 131072 + \
            item * coef
        assert b['operations'] == 77208.0 * 131072
    b = bound.jacobian_bound(m, 131072, 'float64')
    assert b['bound_by'] == 'bytes'
    assert b['least_s'] == b['bytes'] / 3.35e12
    assert abs(b['least_s'] - 0.913e-3) < 1e-6
