"""The benchmark's own tests: ``python -m pytest gpubench/tests`` from the
root of the repository. The ``cuda`` cases run each cell on the card and
skip where there is none."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
