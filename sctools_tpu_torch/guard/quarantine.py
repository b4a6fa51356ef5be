"""Poison-record quarantine sidecars: their reader.

The port's copy of the part of ``sctools_tpu.guard.quarantine`` that the
scheduler calls (guard/quarantine.py:140-168). The JAX guard appends one
JSONL line per isolated poison-record range to a per-worker
``records-<worker>.jsonl`` under the run's quarantine directory (by
convention ``<journal_dir>/quarantine/``); ``sched status`` reads them with
:func:`load_quarantine`. The writer, ``record_quarantine``, and the
directory's setting (``set_quarantine_dir``, ``quarantine_dir``,
``SCTOOLS_TPU_GUARD_QUARANTINE``) are not ported: only the guard's
recovery ladder, which the port does not have, writes sidecars.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List


def load_quarantine(base: str) -> List[Dict[str, Any]]:
    """Every worker's sidecar entries under ``base`` (stream order).

    Torn trailing lines (a worker killed mid-append) are skipped, same
    contract as the journal's scan.
    """
    entries: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(base, "records-*.jsonl"))):
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entry = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(entry, dict):
                        entries.append(entry)
        except OSError:
            continue
    entries.sort(
        key=lambda e: (
            str(e.get("task") or ""),
            e.get("record_start") or 0,
        )
    )
    return entries
