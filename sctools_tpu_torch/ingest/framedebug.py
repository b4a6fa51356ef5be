"""The frame generation witness: stale reads of recycled arena slots raise.

The port's copy of ``sctools_tpu.ingest.framedebug`` without its flight
dumps and trace files. Every ``ingest.arena.ColumnArena`` carries a
generation counter, bumped each time the slot is reclaimed for a refill.

Off by default, and off means off: with ``SCTOOLS_TPU_FRAME_DEBUG`` unset (or
anything but ``1``) ``ColumnArena.frame()`` returns a plain ``ReadFrame``.
With ``SCTOOLS_TPU_FRAME_DEBUG=1``:

- each frame handed out is a ``WitnessFrame`` stamped with its arena and
  the generation it was built from; views derived from it
  (``slice_frame``, ``compact_frame``) inherit the stamp, and a
  ``copy_frame`` sheds it (the copy owns its memory);
- a recycled slot is filled with ``POISON_BYTE`` before its refill, so a
  raw view kept past the window reads unmistakable garbage;
- reading a per-record column (or ``extras``) of a frame whose slot was
  reclaimed since its stamp records a violation and raises
  ``StaleFrameError`` at that line. The vocabularies are owned lists, not
  arena views, and are not checked.

The tests use it to prove a consumer's retention window.
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, List, Optional

from ..analysis.witness import make_lock
from ..io.packed import _PER_RECORD_FIELDS, ReadFrame

ENV_FLAG = "SCTOOLS_TPU_FRAME_DEBUG"

# what a recycled slot holds until its refill: 0xAB in every byte makes
# int32 columns read -1414812757 and bools read True, which no decoded batch
# gives as a whole column
POISON_BYTE = 0xAB

_lock = make_lock("ingest.framedebug")
_stamped = 0
_violations: List[Dict[str, Any]] = []

# the reads that touch a frame's record data: every per-record column and
# the extras dict
_CHECKED_FIELDS = frozenset(_PER_RECORD_FIELDS) | {"extras"}


def enabled() -> bool:
    """Whether the witness is on (``SCTOOLS_TPU_FRAME_DEBUG=1``)."""
    return os.environ.get(ENV_FLAG, "") == "1"


class StaleFrameError(RuntimeError):
    """A consumer read a frame whose arena slot was recycled since."""


def _touch_site() -> str:
    """file:line of the reader outside this module."""
    here = os.path.basename(__file__)
    for entry in reversed(traceback.extract_stack()):
        if os.path.basename(entry.filename) != here:
            return f"{entry.filename}:{entry.lineno}"
    return "<unknown>"


class WitnessFrame(ReadFrame):
    """A stamped arena frame: each column read checks the slot's generation."""

    def _stamp(self, arena: Any, generation: int, batch_index: Optional[int]) -> "WitnessFrame":
        d = object.__getattribute__(self, "__dict__")
        d["_arena"] = arena
        d["_generation"] = generation
        d["_batch_index"] = batch_index
        return self

    def __getattribute__(self, name: str):
        if name in _CHECKED_FIELDS:
            d = object.__getattribute__(self, "__dict__")
            arena = d.get("_arena")
            if arena is not None and arena.generation != d["_generation"]:
                detail = {
                    "slot": arena.slot,
                    "batch_index": d.get("_batch_index"),
                    "stamped_generation": d["_generation"],
                    "arena_generation": arena.generation,
                    "column": name,
                    "site": _touch_site(),
                }
                with _lock:
                    _violations.append(detail)
                raise StaleFrameError(
                    f"frame of batch {detail['batch_index']} (slot {arena.slot}, generation "
                    f"{d['_generation']}) read after the slot was recycled to generation "
                    f"{arena.generation} at {detail['site']}: the consumer held it past the "
                    "ring's retention window; copy_frame() what is kept"
                )
        return object.__getattribute__(self, name)

    def _view(self, **kwargs) -> ReadFrame:
        """A derived view inherits the stamp."""
        d = object.__getattribute__(self, "__dict__")
        return WitnessFrame(**kwargs)._stamp(d["_arena"], d["_generation"], d["_batch_index"])


def stamp_frame(frame_kwargs: Dict[str, Any], arena: Any, batch_index: Optional[int]) -> WitnessFrame:
    """A WitnessFrame over ``arena`` at its current generation."""
    global _stamped
    out = WitnessFrame(**frame_kwargs)._stamp(arena, arena.generation, batch_index)
    with _lock:
        _stamped += 1
    return out


def stamped_count() -> int:
    """How many frames were handed out stamped in this process."""
    with _lock:
        return _stamped


def violations() -> List[Dict[str, Any]]:
    """The stale reads recorded so far."""
    with _lock:
        return [dict(v) for v in _violations]


def reset() -> None:
    """Clear the stamped count and the violations."""
    global _stamped
    with _lock:
        _stamped = 0
        _violations.clear()
