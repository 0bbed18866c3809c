"""Run one cell of the benchmark of ``pyjac_tpu_torch`` on the card.

    python3 benchmarks/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--control]

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; then
``checks``, each compared number beside its limit, which are also the
last lines of standard error.  Without a CUDA card with as many devices
as the cell asks for, or with ``jax``, ``jaxlib``, ``flax``,
``pyjac_tpu`` or ``bench`` loaded once the window has closed, it exits
non-zero and prints no result.

``--control`` puts the plain reference, in the precision below the
cell's, in the program's place (the check that the comparison fails it);
the benchmark's own runs do not use it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _caches():
    """Every build and kernel cache at a fixed path inside the
    checkout."""
    build = ROOT / 'build'
    os.environ['PYJAC_TORCH_BUILD_DIR'] = str(build / 'kernels')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['USE_FLAX'] = '0'


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', action='store_true')
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from benchmarks.harness import cells
    cell = cells.load(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print('run.py: %s needs %d CUDA device(s); this machine has %s'
              % (cell.name, cell.chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 'none'), file=sys.stderr)
        return 1
    from benchmarks.harness import runner
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          'cuda', control=args.control, t_start=T_START)
    found = runner.forbidden_modules()
    if found:
        print('run.py: the process holds %s' % ', '.join(found),
              file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
