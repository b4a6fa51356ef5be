"""Each cell for a few seconds on the card, through the command the
benchmark's checks run. Run on a machine with a card:

    python -m pytest -p no:cacheprovider -q gpubench/tests/test_gpubench_card.py
"""

import json
import subprocess
import sys

import pytest

from gpubench import core


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in core.load_manifest()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed", "3000000777",
                          "--seconds", "3", "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
