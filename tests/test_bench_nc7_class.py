"""The benchmark's n-heptane class (``nc7-class``, 654 species and 2827
reactions) and its cell ``nc7-eval-B4096``, on the CPU: the cell's files
are found by name; the frozen generator's text parses in the reference
and in the program's front end; the program's plain K1 + K2 path agrees
with the reference on states of the cell's mix under the cell's own
limits; and K1's planner keeps one state a tile at this width, eight at
the flagship."""

import numpy as np
import pytest
import torch

from benchmarks.harness import cells, compare, inputs
from benchmarks.harness.cells import module
from pyjac_tpu_torch.ops import kernels
from pyjac_tpu_torch.ops.jacobian_sparse import SparseJacobian
from pyjac_tpu_torch.testers.synthetic import flagship, packed_from_text

torch.set_num_threads(1)

CELL = 'nc7-eval-B4096'
SEED = 2200000001


@pytest.fixture(scope='module')
def nc7():
    """(the cell, the reference's mechanism, the program's packed
    mechanism) of the frozen generator's text."""
    cell = cells.load(CELL)
    text = inputs.mechanism_text(cell.config)
    ref = module('reference', cell.config['reference'])
    _, packed = packed_from_text(text)
    return cell, ref.Mechanism(text), packed


def test_cell_files_are_found(nc7):
    cell = nc7[0]
    assert cell.chips == 1
    assert cell.config['name'] == 'nc7-class'
    assert cell.config['args'] == {'n_species': 654, 'n_reactions': 2827,
                                   'seed': 5}
    assert cell.config['reduced'] == []
    assert (cell.traffic['call'], cell.traffic['dtype'],
            cell.traffic['batch']) == ('eval_dd', 'float64', 4096)
    assert set(cell.limits) == {'jac_err', 'dydt_err'}
    assert 'stage_b_write_pct' in {m['name'] for m in cell.per_layer}
    assert {m['name'] for m in cell.end_to_end} == {
        'evals_per_s', 'call_ms_p95', 'setup_s'}


def test_text_parses_in_reference_and_front_end(nc7):
    _, m, packed = nc7
    assert (m.N, m.R) == (654, 2827)
    assert (packed.n_species, packed.n_reactions) == (654, 2827)


class _Plain:
    """The program's plain K1 + K2 path on the CPU, answering as the
    benchmark's call modules do."""

    def __init__(self, packed, states):
        J, f = SparseJacobian(packed, device='cpu')(states.y, states.P)
        self.out = J, f

    def answers(self, out, pos):
        J, f = out
        return J[pos], f[pos]


def test_plain_path_matches_reference_under_cell_limits(nc7):
    """Two states of the mix (the batch's hottest at the highest pressure
    and its coldest), through ``compare.jacobian_numbers``: the numbers
    that decide ``correct``, held to the cell's limits."""
    cell, m, packed = nc7
    ref = module('reference', cell.config['reference'])
    drawn = inputs.draw_states(cell.config, cell.traffic, SEED)
    y, P = drawn.y, drawn.P
    pick = [int(np.argmax(y[:, 0] * P)), int(np.argmin(y[:, 0]))]
    states = inputs.States(y[pick], P[pick], np.arange(2))
    program = _Plain(packed, states)
    nums = compare.jacobian_numbers(ref, m, m.tensors('cpu'), states,
                                    program, [program.out], 'cpu')
    assert nums['nonfinite'] == 0
    for k in ('jac_err', 'dydt_err'):
        assert nums[k] <= cell.limits[k]['limit'], (k, nums[k])


def test_stage_a_plan_at_this_width_and_the_flagship(nc7):
    sj = SparseJacobian(nc7[2], device='cpu')
    plan = kernels.tile_plan(sj, torch.float64, 4096)
    assert (plan['placement'], plan['tile']) == ('shared', 1)
    assert plan['smem_bytes'] <= kernels.SMEM_MAX
    assert kernels.TILE_THREADS < 654 + 1     # no spare thread group
    flag = kernels.tile_plan(SparseJacobian(flagship()[1], device='cpu'),
                             torch.float64, 131072)
    assert (flag['placement'], flag['tile']) == ('shared', 8)
