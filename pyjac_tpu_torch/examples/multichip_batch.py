"""Example: sharding a large state batch over a batch mesh.

Port of ``examples/multichip_batch.py``: analytical Jacobians of a
PaSR-style batch of the in-repo 53-species flagship with the states
sharded over a mesh (``parallel.mesh``).  On the card the mesh is an
NCCL process group with this process's card (one card a process: start
one process per card with ``torchrun``; alone, the script makes a group
of one on localhost); with ``--device cpu``, ``--shards`` virtual shards
of the CPU (the analog of the JAX script's forced host device count).
The fused sharded step runs the plain float64 ``jacobian_and_dydt``
with JAX's error norm across the group; the chunked evaluation of a
batch larger than one dispatch runs ``BatchEvaluator.jacobian_dd``,
each chunk split over the mesh (on the card the stage kernels K1 + K2).

Run:  python -m pyjac_tpu_torch.examples.multichip_batch [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch.distributed as dist

from ..ops.common import entry_device
from ..parallel.mesh import (BatchEvaluator, _free_port, batch_sharding,
                             initialize_distributed, make_mesh,
                             sharded_step)
from ..testers.synthetic import flagship, random_states

STATES = os.path.join(os.path.dirname(__file__), '..', '..', 'tests', 'data',
                      'flagship_states.npz')


def join_group(device) -> bool:
    """Join (or make) the NCCL group of this process's card: the
    launcher's (``torchrun``'s MASTER_ADDR / MASTER_PORT, WORLD_SIZE,
    RANK), else a group of one on localhost.  Returns whether this call
    initialised it."""
    if dist.is_initialized():
        return False
    env = os.environ
    addr = ('%s:%s' % (env['MASTER_ADDR'], env['MASTER_PORT'])
            if 'MASTER_ADDR' in env else 'localhost:%d' % _free_port())
    initialize_distributed(addr, int(env.get('WORLD_SIZE', 1)),
                           int(env.get('RANK', 0)), device)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--shards', type=int, default=4,
                    help='virtual shards of the CPU (--device cpu)')
    ap.add_argument('--step-states', type=int, default=64,
                    help='states per shard of the sharded step')
    ap.add_argument('--states', type=int, default=10_000,
                    help='states of the chunked evaluation')
    ap.add_argument('--chunk', type=int, default=256)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    mech, packed = flagship()
    made = join_group(device) if device.type == 'cuda' else False
    try:
        mesh = (make_mesh(device=device) if device.type == 'cuda' else
                make_mesh(args.shards, device))
        print('mesh devices:', mesh.size)

        # one fused sharded step (J, dydt, global norm over the group)
        step = sharded_step(packed, mesh)
        d = np.load(STATES)
        n = min(args.step_states * mesh.size, len(d['y']))
        y, P = d['y'][:n], d['P'][:n]
        J, f, norm = step(y, P)
        shards = ['%d:%d %s' % (s, e, dev)
                  for _, dev, s, e in batch_sharding(mesh, n)]
        print('sharded step: J %s sharded as %s; global norm %.3e' %
              (tuple(J.shape), shards, float(norm)))

        # chunked evaluation of a batch larger than one dispatch
        ev = BatchEvaluator(packed, mesh, chunk_size=args.chunk)
        y_big, _, P_big = random_states(mech, args.states, seed=1)
        J_big, f_big = ev.jacobian_dd(y_big, P_big)
        print('chunked: %d states -> J %s, dydt %s' %
              (len(y_big), J_big.shape, f_big.shape))
        return {'mesh': mesh, 'y': y, 'P': P, 'J': J, 'f': f, 'norm': norm,
                'y_big': y_big, 'P_big': P_big, 'J_big': J_big,
                'f_big': f_big, 'packed': packed}
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
