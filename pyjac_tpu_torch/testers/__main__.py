"""``python -m pyjac_tpu_torch.testers`` — functional (parity) tester CLI
(reference parity: pyjac/functional_tester/__main__.py)."""

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='pyjac_tpu_torch.testers',
        description='Functional parity tester: evaluates all kernels over '
                    'sampled states and compares against the NumPy / '
                    'forward-AD / finite-difference oracles.')
    parser.add_argument('-i', '--input', required=True,
                        help='Mechanism file (.inp/.dat/.cti/.yaml/.xml).')
    parser.add_argument('-t', '--thermo', default=None)
    parser.add_argument('-ls', '--last_species', default=None)
    parser.add_argument('-d', '--data', default=None,
                        help='PaSR state data .npy '
                             '([.., (t, T, P, Y...)]); random states '
                             'are generated if omitted.')
    parser.add_argument('-n', '--num_states', type=int, default=32)
    parser.add_argument('--conv', action='store_true', default=False)
    parser.add_argument('-o', '--out', default='error_arrays.npz')
    parser.add_argument('--fail-above', type=float, default=1e-8,
                        dest='fail_above',
                        help='Exit non-zero if the worst thresholded '
                             'max-relative Jacobian error (closed form '
                             'against forward-mode AD, entries above '
                             '||J|| / 1e20) exceeds this; default 1e-8. '
                             'The port computes in IEEE float64 on the '
                             'card and on the CPU alike, so one gate '
                             'serves both.')
    parser.add_argument('-or', '--only_reaction', default=None,
                        help='Comma-separated reaction indices: strip '
                             'the mechanism to just these for triage '
                             '(reference test.py:1139-1144).')
    parser.add_argument('-cn', '--condition_numbers', default=None,
                        help='Comma-separated state indices to test '
                             '(reference test.py:1260-1262).')
    parser.add_argument('--device', default='cuda',
                        help="where the evaluations run: 'cuda' "
                             "(default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..core.mech import Mechanism
    from ..core.pack import pack
    from .functional import run_functional_test
    from .synthetic import random_states

    mech = Mechanism.from_files(args.input, args.thermo,
                                last_spec=args.last_species)
    if args.only_reaction:
        mech = mech.restrict_reactions(
            [int(x) for x in args.only_reaction.split(',')])
    packed = pack(mech)

    if args.data:
        states = np.load(args.data)
        states = states.reshape(-1, states.shape[-1])
    else:
        y, T, P = random_states(mech, args.num_states, seed=0)
        Y_full = np.concatenate(
            [y[:, 1:], (1.0 - y[:, 1:].sum(1))[:, None]], axis=1)
        back = np.asarray(mech.back_spec_mapping)
        states = np.concatenate(
            [np.zeros((len(T), 1)), T[:, None], P[:, None],
             Y_full[:, back]], axis=1)

    cn = ([int(x) for x in args.condition_numbers.split(',')]
          if args.condition_numbers else None)
    err = run_functional_test(mech, packed, states, conp=not args.conv,
                              num_states=args.num_states,
                              out_file=args.out, condition_numbers=cn,
                              device=args.device)
    worst = err['err_jac_thr_max'].max()
    if not (worst <= args.fail_above):      # NaN must fail too
        print('FAIL: thresholded Jacobian error %.3e > %.1e' %
              (worst, args.fail_above), file=sys.stderr)
        return 1
    print('PASS: worst thresholded Jacobian error %.3e' % worst)
    return 0


if __name__ == '__main__':
    sys.exit(main())
