"""Stiff integration of a batch of states over one flow step.

Program: ``pyjac_tpu_torch.integrate(packed, y0, P, t_end, jacobian=...,
method=..., rtol=..., atol=...)`` with the traffic file's ``integrate``
settings; the mechanism comes through the program's own front end.  A
call ends when its loop's ``iterations`` has reached the host; the
caller then waits for the final states with one synchronize.

Control: the reference's ROS23 in float32 (the precision below float64)
in the program's place, cut off after ``CONTROL_ITERATIONS`` loop
iterations (a state cut off reads status 3).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.harness.cells import module

_dd = module('calls', 'eval_dd')
kind = 'integrate'
CONTROL_ITERATIONS = 2000


class Program:
    def __init__(self, ctx):
        from pyjac_tpu_torch import integrate
        from pyjac_tpu_torch.core.mech import Mechanism
        from pyjac_tpu_torch.core.pack import pack
        self.packed = pack(Mechanism.from_files(str(ctx.mech_path)))
        self.integrate = integrate
        self.spec = ctx.traffic['integrate']
        self.conp = ctx.conp
        self.device = ctx.device
        self.y0 = torch.as_tensor(ctx.states.y, device=ctx.device)
        self.P = torch.as_tensor(ctx.states.P, device=ctx.device)
        self.states = self.y0.shape[0]

    def call(self):
        s = self.spec
        return self.integrate(self.packed, self.y0, self.P, s['t_end'],
                              conp=self.conp, rtol=s['rtol'],
                              atol=s['atol'], jacobian=s['jacobian'],
                              method=s['method'], device=self.device)

    def wait(self, out):
        _dd._wait(self.device)

    def counters(self, out) -> dict:
        return {'iterations': int(out.iterations)}

    def status(self, out):
        return out.status

    def answers(self, out, pos):
        """(y (n, N), status (n,)) of batch positions ``pos``."""
        p = torch.as_tensor(pos, device=self.device)
        return out.y[p], out.status[p]

    def free(self):
        del self.y0, self.P


class Control(Program):
    """The reference's integration in float32 of each distinct state."""

    def __init__(self, ctx):
        self.ref = ctx.ref
        self.spec = ctx.traffic['integrate']
        self.device = ctx.device
        self.tables = ctx.mech.tensors(ctx.device, torch.float32)
        uniq, inv = np.unique(ctx.states.idx, return_inverse=True)
        self.y0 = torch.as_tensor(ctx.states.pool_y[uniq],
                                  device=ctx.device).float()
        self.P = torch.as_tensor(ctx.states.pool_P[uniq],
                                 device=ctx.device).float()
        self.inv = torch.as_tensor(inv, device=ctx.device)
        self.states = len(inv)

    def call(self):
        s = self.spec
        return self.ref.integrate(self.tables, self.y0, self.P, s['t_end'],
                                  s['rtol'], s['atol'],
                                  max_iterations=CONTROL_ITERATIONS)

    def counters(self, out) -> dict:
        return {}

    def status(self, out):
        return out[1][self.inv]

    def answers(self, out, pos):
        p = self.inv[torch.as_tensor(pos, device=self.device)]
        return out[0][p], out[1][p]
