"""stage_b_write_pct: K2's share of the bound its output sets, in
percent: the least time in which the card's HBM takes the J that K2
(``csrc/sparse_stage_b.cu``, op ``pyjac_tpu_torch::stage_b``) writes,
its N - 1 species columns of N float64 rows a state, (N - 1) N 8 B
bytes a call at ``harness/bound.py``'s bandwidth, over the op's device
time per traced call.  N is the configuration's ``n_species`` and B the
states a call takes, so the count is the work's whatever implements K2.
None where the op did not run."""

from benchmarks.harness import bound


def read(run):
    s = run.trace.op_device_s('pyjac_tpu_torch::stage_b') if run.trace \
        else None
    if not s:
        return None
    N = int(run.cell.config['n_species'])
    least = (N - 1) * N * 8 * run.states_per_call / bound.HBM_BYTES_S
    return 100.0 * least / (s / run.trace.calls)
