"""Run one benchmark cell once: ``python3 gpubench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of the repository.

The last line of standard output is the result as one JSON object; the
numbers the output check compared, each with its limit, are the last lines
of standard error. See README.md beside this file.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
