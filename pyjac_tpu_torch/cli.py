"""Command-line interface.

Port of ``pyjac_tpu/cli.py``, which mirrors the reference's CLI surface
(reference: pyjac/utils.py:306-435, pyjac/__main__.py:7-26): instead of
emitting C/CUDA source into ``build_path``, it packs the mechanism into
constant tensors, writes the packed archive plus a JSON manifest (the
``mechanism.h`` analog: NSP/NN/FWD_RATES/REV_RATES/PRES_MOD_RATES,
species table, last-species pivot — mech_auxiliary.py:133-161), and can
self-validate the analytical Jacobian against forward-mode AD
(``torch.func.jacfwd``) on the CUDA card, or on the CPU with
``--device cpu``.  The archive and manifest are the JAX package's, byte
for byte in content: either package loads the other's archive.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='pyjac_tpu_torch',
        description='pyjac_tpu_torch: analytical chemical Jacobians in '
                    'PyTorch with hand-written CUDA kernels for the H100, '
                    'a port of pyjac_tpu.')
    parser.add_argument('-l', '--lang', type=str, default='cuda',
                        choices=['cuda', 'torch'],
                        help='Target platform (kept for pyJac CLI parity; '
                             'both values mean the PyTorch + CUDA '
                             'pipeline).')
    parser.add_argument('-i', '--input', type=str, required=True,
                        help='Input mechanism filename '
                             '(.inp/.dat Chemkin; .cti/.yaml/.xml Cantera).')
    parser.add_argument('-t', '--thermo', type=str, default=None,
                        help='Thermodynamic database filename, or nothing '
                             'if contained in the mechanism file.')
    parser.add_argument('-ic', '--initial-conditions', type=str,
                        dest='initial_conditions', default='',
                        help='Comma-separated initial conditions: '
                             'T,P,Sp1=x1,... (T in K, P in atm, species '
                             'in moles).')
    parser.add_argument('-b', '--build_path', default='./out/',
                        help='Output folder for the packed mechanism '
                             'archive and manifest.')
    parser.add_argument('-ls', '--last_species', type=str, default=None,
                        help='Species eliminated by the 1-sum(Y) closure; '
                             'defaults to the first of N2, AR, HE present.')
    parser.add_argument('-sj', '--skip_jac', action='store_true',
                        default=False,
                        help='Skip the Jacobian self-validation step '
                             '(rates only).')
    parser.add_argument('--conv', action='store_true', default=False,
                        help='Validate in constant-volume (CONV) mode '
                             'instead of constant-pressure (CONP).')
    parser.add_argument('--validate', action='store_true', default=False,
                        help='Cross-check the closed-form Jacobian against '
                             'forward-mode AD on sampled states.')
    parser.add_argument('--states', type=int, default=16,
                        help='Number of random states for --validate.')
    parser.add_argument('--device', default='cuda',
                        help="Where --validate runs: 'cuda' (default) or "
                             "'cpu'.")
    # ---- accepted-for-parity no-ops (CUDA/cache-optimizer specific in
    # the reference, utils.py:357-411): the port's kernels are compiled
    # once from csrc/ and plan their own tiles ----------------------------
    noop = parser.add_argument_group(
        'reference-compatibility (accepted, no effect on the port)')
    noop.add_argument('-co', '--cache-optimizer', dest='cache_optimizer',
                      action='store_true', default=False,
                      help='no-op: the kernels read the packed tables in '
                           'their own order (reactions by category, '
                           'columns longest row first)')
    noop.add_argument('-nosmem', '--no-shared-memory', dest='no_shared',
                      action='store_true', default=False,
                      help='no-op: each kernel chooses where a state '
                           "tile's rows live (shared memory or per-block "
                           'global slices, kernels.tile_plan)')
    noop.add_argument('-pshare', '--prefer-shared', dest='L1_preferred',
                      action='store_false', default=True,
                      help='no-op: each kernel sets its own dynamic '
                           'shared-memory size')
    noop.add_argument('-nb', '--num-blocks', type=int, default=8,
                      help='no-op: the kernels size their grids from the '
                           'batch and their tile plan')
    noop.add_argument('-nt', '--num-threads', type=int, default=64,
                      help='no-op: each kernel has a fixed block size')
    noop.add_argument('-mt', '--multi-threaded', type=int, default=None,
                      help='no-op: no code is generated per mechanism; '
                           'the kernels are compiled once, all sources '
                           'in parallel')
    noop.add_argument('-fopt', '--force-optimize', action='store_true',
                      default=False,
                      help='no-op: nothing to re-optimize')
    return parser


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    from .core.mech import Mechanism
    from .core.pack import pack, save_packed

    if args.cache_optimizer or args.no_shared or not args.L1_preferred \
            or args.force_optimize:
        print('note: CUDA/cache-optimizer flags are accepted for pyJac '
              'CLI compatibility but have no effect: the kernels choose '
              'their own tile plan', file=sys.stderr)

    mech = Mechanism.from_files(args.input, args.thermo,
                                last_spec=args.last_species)
    packed = pack(mech)

    os.makedirs(args.build_path, exist_ok=True)
    archive = os.path.join(args.build_path, 'mech_packed.npz')
    save_packed(packed, archive)

    manifest = {
        'source': args.input,
        'NSP': packed.n_species,
        'NN': packed.n_species + 1,
        'FWD_RATES': packed.n_reactions,
        'REV_RATES': packed.n_rev,
        'PRES_MOD_RATES': packed.n_pres_mod,
        'last_species': mech.specs[-1].name,
        'species': mech.species_names,
        'fwd_spec_mapping': list(mech.fwd_spec_mapping),
        'back_spec_mapping': list(mech.back_spec_mapping),
        'features': {
            'reversible': packed.has_rev,
            'third_body': packed.has_thd_only,
            'falloff': packed.has_falloff,
            'chemically_activated': packed.has_chemact,
            'troe': packed.has_troe,
            'sri': packed.has_sri,
            'plog': packed.has_plog,
            'chebyshev': packed.has_cheb,
        },
    }
    man_path = os.path.join(args.build_path, 'mechanism_info.json')
    with open(man_path, 'w') as fh:
        json.dump(manifest, fh, indent=2)

    print('packed %d species / %d reactions (last species: %s)' %
          (packed.n_species, packed.n_reactions, mech.specs[-1].name))
    print('wrote %s and %s' % (archive, man_path))

    if args.initial_conditions:
        import numpy as np

        from .utils import parse_initial_conditions, state_vector
        T, P, Y = parse_initial_conditions(packed, args.initial_conditions)
        y0 = state_vector(packed, np.asarray(T), Y)
        np.save(os.path.join(args.build_path, 'initial_state.npy'),
                np.concatenate([[P], y0]))
        print('initial state: T=%.2f K, P=%.1f Pa -> initial_state.npy'
              % (T, P))

    if args.validate and not args.skip_jac:
        import numpy as np

        from .ops.common import as_f64, entry_device
        from .ops.jacobian import eval_jacobian, jacobian_fwd
        from .ops.thermo import eval_conc
        from .testers.synthetic import random_states

        device = entry_device(args.device)
        y, T, P = random_states(mech, args.states, seed=0)
        y, T, P = (as_f64(a, device) for a in (y, T, P))
        conp = not args.conv
        if conp:
            param = P
        else:
            _, _, param, _ = eval_conc(packed, T, P, y[:, 1:])
        J = eval_jacobian(packed, 0.0, param, y, conp=conp)
        J_ref = jacobian_fwd(packed, 0.0, param, y, conp=conp)
        Jn, Jr = J.cpu().numpy(), J_ref.cpu().numpy()
        scale = float(np.abs(Jr).max()) + 1e-300
        err = float(np.abs(Jn - Jr).max()) / scale
        print('jacobian self-validation (%s, %d states): '
              'max scaled err %.3e' %
              ('CONP' if conp else 'CONV', args.states, err))
        if not (err <= 1e-8):        # NaN must fail, not slip through
            print('VALIDATION FAILED', file=sys.stderr)
            return 1
    return 0
