"""The numbers that decide ``correct``: what the program's timed calls
returned against the plain reference, state by state.

The reference runs on each distinct state of the batch once (a PaSR
draw repeats states), in blocks, after the window; every position of
every retained call is compared with its state's reference answer.

* ``jacobian`` cells: ``jac_err``, the largest over states, rows and
  the two column blocks (the temperature column, the species columns)
  of max |J - J_ref| over the block's entries, divided by the larger of
  the reference's max |J_ref| there and ``JAC_FLOOR`` times the state's
  largest |J_ref| of that row kind (temperature row or species rows)
  and column block; ``dydt_err``, the largest over states and rows of
  |f - f_ref| over the sum of the magnitudes of the row's terms
  (``dydt_scale``).
* ``integrate`` cells: ``y_err``, the largest |y - y_ref| / (atol +
  rtol |y_ref|) over states and components of the final states;
  ``status_mismatch``, the states whose status differs from the
  reference's; ``unfinished``, the states of every window call that did
  not reach t_end (the reference reaches it on every state of the PaSR
  file).

A non-finite answer reads ``inf``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

JAC_FLOOR = 1e-3
TINY = 1e-300


def block_size(m) -> int:
    """States a reference block holds: about 5e7 reaction-species
    products of forward-mode tangents."""
    return int(min(4096, max(64, 5e7 // (m.N * m.R))))


def _blocks(states, blk):
    """(pool rows, batch positions, each position's row within the
    block) over blocks of ``blk`` distinct pool rows."""
    uniq, inv = np.unique(states.idx, return_inverse=True)
    order = np.argsort(inv, kind='stable')
    cut = np.searchsorted(inv[order], np.arange(0, len(uniq) + blk, blk))
    for k in range(0, len(uniq), blk):
        pos = order[cut[k // blk]:cut[k // blk + 1]]
        yield uniq[k:k + blk], pos, inv[pos] - k


def _jac_err(Jp, Jr):
    """Per state (n,): jac_err's reading."""
    err = torch.zeros(Jr.shape[0], dtype=torch.float64, device=Jr.device)
    for rows in (slice(0, 1), slice(1, None)):
        for cols in (slice(0, 1), slice(1, None)):
            r = Jr[:, rows, cols].abs().amax(-1)               # (n, rows)
            d = (Jp[:, rows, cols] - Jr[:, rows, cols]).abs().amax(-1)
            scale = torch.maximum(r, JAC_FLOOR * r.amax(-1, keepdim=True))
            e = torch.where(d == 0, 0.0, d / scale.clamp(min=TINY))
            err = torch.maximum(err, e.amax(-1))
    return err


def _bad(x):
    return ~torch.isfinite(x).reshape(x.shape[0], -1).all(-1)


def jacobian_numbers(ref, m, tables, states, program, outs,
                     device) -> dict:
    """{'jac_err', 'dydt_err', 'nonfinite'} of the retained calls
    ``outs`` (``ref``: the reference module, ``m`` its mechanism,
    ``tables`` its float64 tensors)."""
    je = de = 0.0
    nonfinite = 0
    for rows, pos, at in _blocks(states, block_size(m)):
        y = torch.as_tensor(states.pool_y[rows], device=device)
        P = torch.as_tensor(states.pool_P[rows], device=device)
        Jr, fr = ref.jacobian(tables, y, P)
        sc = ref.dydt_scale(tables, y, P)
        at_t = torch.as_tensor(at, device=device)
        for out in outs:
            Jp, fp = program.answers(out, pos)
            Jp, fp = Jp.double(), fp.double()
            bad = _bad(Jp) | _bad(fp)
            nonfinite += int(bad.sum())
            ej = _jac_err(Jp, Jr[at_t])
            d = (fp - fr[at_t]).abs()
            ef = torch.where(d == 0, 0.0, d / sc[at_t].clamp(min=TINY))
            ef = ef.amax(-1)
            ej = torch.where(bad, math.inf, ej)
            ef = torch.where(bad, math.inf, ef)
            je = max(je, float(ej.max()))
            de = max(de, float(ef.max()))
    return {'jac_err': je, 'dydt_err': de, 'nonfinite': nonfinite}


def integrate_numbers(ref, m, tables, states, program, outs, device,
                      spec: dict) -> dict:
    """{'y_err', 'status_mismatch'} of the retained calls ``outs``."""
    ye = 0.0
    mism = 0
    # the loop holds one Jacobian a state at a time: blocks 4 times larger
    for rows, pos, at in _blocks(states, 4 * block_size(m)):
        y0 = torch.as_tensor(states.pool_y[rows], device=device)
        P = torch.as_tensor(states.pool_P[rows], device=device)
        yr, sr = ref.integrate(tables, y0, P, spec['t_end'], spec['rtol'],
                               spec['atol'])
        at_t = torch.as_tensor(at, device=device)
        yr, sr = yr[at_t], sr[at_t]
        for out in outs:
            yp, sp = program.answers(out, pos)
            e = (yp.double() - yr).abs() / (spec['atol'] +
                                             spec['rtol'] * yr.abs())
            e = torch.where(torch.isfinite(e), e, math.inf).amax(-1)
            ye = max(ye, float(e.max()))
            mism += int((sp.to(sr.dtype) != sr).sum())
    return {'y_err': ye, 'status_mismatch': mism}
