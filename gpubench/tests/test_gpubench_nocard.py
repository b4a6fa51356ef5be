"""The measurement path fails where it finds no card: no result line, an
exit code other than 0. Skips on a machine that has one."""

import json
import subprocess
import sys

import pytest

from gpubench import core


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not reachable here")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "fastq-10xv3", "--seed", "3000000123",
                          "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "refused" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_unknown_cell_refuses():
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "no-such-cell", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
