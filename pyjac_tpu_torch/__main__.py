"""``python -m pyjac_tpu_torch`` entry point
(reference parity: pyjac/__main__.py:7-26)."""

import sys

from .cli import main

if __name__ == '__main__':
    sys.exit(main())
