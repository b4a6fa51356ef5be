"""The validation a part merge runs before it reads a byte.

The port of the checks in ``sctools_tpu.parallel.launch`` (:314-423) that
both part merges share, ``parallel.launch.merge_sorted_csv_parts`` and
``metrics.collective.collective_merge_parts``: the ``.partNNNN`` sequence
is gap- and duplicate-free, and with a journal the parts on disk are
exactly its committed set, hash-verified, with no task quarantined.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence

from .commit import sha256_file
from .journal import COMMITTED, QUARANTINED, Journal

_PART_INDEX = re.compile(r"\.part(\d+)\.csv(?:\.gz)?$")


def _check_part_sequence(
    paths: Sequence[str],
    part_pattern: str,
    expected_parts: Optional[int] = None,
) -> None:
    """Missing, duplicated, or out-of-range part indices must fail loudly.

    A missing part (a worker died after the glob's neighbours committed, a
    stale journal, a wrong pattern) would otherwise give a truncated
    merged CSV. Parts are named by global chunk index, so the committed
    sequence must be exactly 0..max, or exactly ``0..expected_parts-1``
    when the caller knows the chunk count, which also catches stale
    higher-indexed parts of an earlier, larger run in a reused directory.
    """
    by_index: Dict[int, List[str]] = {}
    for path in paths:
        match = _PART_INDEX.search(os.path.basename(path))
        if match is not None:
            by_index.setdefault(int(match.group(1)), []).append(path)
    if not by_index:
        return  # pattern names no .partNNNN files; nothing to validate
    duplicates = {i: p for i, p in by_index.items() if len(p) > 1}
    if duplicates:
        listing = "; ".join(
            f"part {index}: {', '.join(sorted(paths_))}"
            for index, paths_ in sorted(duplicates.items())
        )
        raise ValueError(
            f"duplicate part indices under {part_pattern!r} ({listing}); "
            "two runs are writing the same output directory"
        )
    if expected_parts is not None:
        stale = sorted(set(by_index) - set(range(expected_parts)))
        if stale:
            raise ValueError(
                f"part indices {stale} under {part_pattern!r} exceed this "
                f"run's {expected_parts} chunk(s): stale parts from an "
                "earlier, larger run share the output directory and must "
                "be removed before the merge"
            )
    top = expected_parts if expected_parts is not None else max(by_index) + 1
    missing = sorted(set(range(top)) - set(by_index))
    if missing:
        raise ValueError(
            f"part sequence under {part_pattern!r} has gaps: missing "
            f"indices {missing} (found {sorted(by_index)}); a merged CSV "
            "would be silently truncated. Re-run the workers or `python "
            "-m sctools_tpu_torch.sched resume <journal>` to materialize them"
        )


def _check_journal_parts(paths: Sequence[str], journal_dir: str) -> None:
    """The globbed parts must be exactly the journal's committed set.

    Catches both directions of drift: a part on disk the journal never
    committed (debris from an aborted earlier run) and a committed part
    the glob missed (deleted, or a too-narrow pattern). Content hashes are
    verified so a stale same-named file from a previous run cannot slip
    through, and quarantined tasks block the merge outright.
    """
    journal = Journal(journal_dir, worker_id="merge-validate")
    tasks, states = journal.replay()
    quarantined = sorted(
        tasks[tid].name if tid in tasks else tid
        for tid, st in states.items()
        if st.state == QUARANTINED
    )
    if quarantined:
        raise ValueError(
            f"journal {journal_dir} holds quarantined task(s) "
            f"{quarantined}; the merge would be missing their rows. "
            "Inspect, `retry-quarantined`, and resume first"
        )
    committed = {
        os.path.abspath(st.part): st
        for st in states.values()
        if st.state == COMMITTED and st.part
    }
    globbed = {os.path.abspath(p) for p in paths}
    stale = sorted(globbed - set(committed))
    if stale:
        raise ValueError(
            f"part file(s) not committed in journal {journal_dir}: "
            f"{stale}; stale debris from an earlier run must be removed "
            "before the merge"
        )
    lost = sorted(set(committed) - globbed)
    if lost:
        raise ValueError(
            f"journal-committed part(s) missing from glob: {lost}; "
            "widen the pattern or restore the files"
        )
    for path, st in sorted(committed.items()):
        digest = sha256_file(path)
        if st.sha256 and digest != st.sha256:
            raise ValueError(
                f"part {path} content hash {digest} does not match the "
                f"journal's committed hash {st.sha256}; the file was "
                "modified or replaced after commit"
            )


def validated_parts(
    part_pattern: str,
    journal_dir: Optional[str] = None,
    expected_parts: Optional[int] = None,
) -> List[str]:
    """The parts ``part_pattern`` names, sorted, after the sequence checks
    and, with ``journal_dir``, the journal checks: the validation both
    part merges run before they read a byte."""
    paths = sorted(glob.glob(part_pattern))
    if not paths:
        raise FileNotFoundError(f"no parts match {part_pattern}")
    _check_part_sequence(paths, part_pattern, expected_parts)
    if journal_dir is not None:
        _check_journal_parts(paths, journal_dir)
    return paths
