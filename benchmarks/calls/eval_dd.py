"""The float64 Jacobian evaluation of a batch resident on the card.

Program: the module ``BatchEvaluator._dd_kernel()`` picks for the
mechanism (``SparseJacobian``, K1 + K2; ``DenseJacobian``, K4, where the
former refuses), built from the Chemkin text through the program's own
front end.  A call is ``call_tr(y (N, B), P (1, B))``; the caller then
waits with one ``torch.cuda.synchronize()``.

Control: the plain reference in float32 (the precision below float64)
in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

kind = 'jacobian'


def _wait(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class Program:
    def __init__(self, ctx):
        from pyjac_tpu_torch.core.mech import Mechanism
        from pyjac_tpu_torch.core.pack import pack
        from pyjac_tpu_torch.parallel.batch import BatchEvaluator
        packed = pack(Mechanism.from_files(str(ctx.mech_path)))
        self.device = ctx.device
        self.mod = BatchEvaluator(packed, conp=ctx.conp,
                                  device=ctx.device)._dd_kernel()
        self.y_t = torch.as_tensor(ctx.states.y.T.copy(), device=ctx.device)
        self.P_t = torch.as_tensor(ctx.states.P[None].copy(),
                                   device=ctx.device)
        self.states = self.y_t.shape[1]

    def call(self):
        return self.mod.call_tr(self.y_t, self.P_t)

    def wait(self, out):
        _wait(self.device)

    def counters(self, out) -> dict:
        return {}

    def answers(self, out, pos):
        """(J (n, N, N), f (n, N)) of batch positions ``pos``."""
        p = torch.as_tensor(pos, device=self.device)
        if len(out) == 3:                      # columns 1..J, col0, f
            cols, col0, f = out
            Jt = torch.cat([col0[None][:, :, p], cols[:, :, p]], 0)
        else:                                  # Jt [column, row, batch], f
            Jt, f = out
            Jt = Jt[:, :, p]
        return Jt.permute(2, 1, 0), f[:, p].T

    def free(self):
        del self.mod, self.y_t, self.P_t


class Control(Program):
    """The reference's J and f in ``dtype`` for every state of the batch
    (each distinct state once, then gathered to its positions)."""
    dtype = torch.float32
    tf32 = False

    def __init__(self, ctx):
        self.device = ctx.device
        self.ref = ctx.ref
        self.tables = ctx.mech.tensors(ctx.device, self.dtype, self.tf32)
        uniq, inv = np.unique(ctx.states.idx, return_inverse=True)
        self.y = torch.as_tensor(ctx.states.pool_y[uniq],
                                 device=ctx.device).to(self.dtype)
        self.P = torch.as_tensor(ctx.states.pool_P[uniq],
                                 device=ctx.device).to(self.dtype)
        self.inv = torch.as_tensor(inv, device=ctx.device)
        self.block = ctx.block
        self.states = len(inv)

    def call(self):
        Js, fs = [], []
        for k in range(0, self.y.shape[0], self.block):
            J, f = self.ref.jacobian(self.tables, self.y[k:k + self.block],
                                     self.P[k:k + self.block])
            Js.append(J)
            fs.append(f)
        return torch.cat(Js), torch.cat(fs)

    def answers(self, out, pos):
        J, f = out
        p = self.inv[torch.as_tensor(pos, device=self.device)]
        return J[p], f[p]

    def free(self):
        del self.y, self.P
