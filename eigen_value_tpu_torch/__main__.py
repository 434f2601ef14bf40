"""``python -m eigen_value_tpu_torch`` — the reference ``./run`` analog.

Defers to the bench CLI (``bench/__main__.py``), which prints the JAX
CLI's fixed-width report tables.
"""

import sys

from .bench.__main__ import main

if __name__ == "__main__":
    sys.exit(main())
