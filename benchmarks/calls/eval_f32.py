"""The float32 Jacobian evaluation of a batch resident on the card.

Program: ``F32Jacobian`` (K3), built from the Chemkin text through the
program's own front end; a call is ``call_tr(y (N, B), P (1, B))`` in
float32, then one ``torch.cuda.synchronize()``.

Control: the plain reference in float32 with its contractions' operands
rounded to TF32 (the precision below float32 with TF32 off, the tensor
cores' step) in the program's place.
"""

from __future__ import annotations

import torch

from benchmarks.harness.cells import module

_dd = module('calls', 'eval_dd')
kind = 'jacobian'


class Program(_dd.Program):
    def __init__(self, ctx):
        from pyjac_tpu_torch.core.mech import Mechanism
        from pyjac_tpu_torch.core.pack import pack
        from pyjac_tpu_torch.ops.jacobian_f32 import F32Jacobian
        packed = pack(Mechanism.from_files(str(ctx.mech_path)))
        self.device = ctx.device
        self.mod = F32Jacobian(packed, conp=ctx.conp, device=ctx.device)
        f32 = torch.float32
        self.y_t = torch.as_tensor(ctx.states.y.T.copy(), dtype=f32,
                                   device=ctx.device)
        self.P_t = torch.as_tensor(ctx.states.P[None].copy(), dtype=f32,
                                   device=ctx.device)
        self.states = self.y_t.shape[1]


class Control(_dd.Control):
    dtype = torch.float32
    tf32 = True
