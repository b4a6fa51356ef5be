"""The packed column arena: caller-owned staging for the native decoder.

The port's copy of ``sctools_tpu.ingest.arena``. One buffer, allocated once,
holds every per-record column of a decoded batch as adjacent sections. The
native decoder writes into it across ctypes
(``native.NativeBatchStream.fill_arena``, ``scx_batch_fill_arena``) and
Python only views the sections with ``np.frombuffer``: no per-record
objects, no per-column copies. The views make an ordinary
``io.packed.ReadFrame``, so everything downstream is unchanged.

``ARENA_SPEC`` is the Python half of the ingest ABI: the C++ side iterates
the same ordered (name, width) list (``kArenaLanes`` in
``native/bamdecode.cpp``), and ``tests/test_torch_ingest.py`` holds the two
sides, and the JAX package's arena, to the same bytes over a real decode.
Two sections are finished on the host because they need host knowledge:
``flags`` arrives with bits 0..11 packed (all but FLAG_MITO and
FLAG_RUN_START, which the gatherer's padder ORs in), and ``ps`` arrives
whole (``pos << 1 | strand``). Both ride ``ReadFrame.extras``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io.packed import PAD_FILLS, ReadFrame
from . import framedebug

# capacity granularity: every section offset stays 64-byte aligned for any
# capacity that is a multiple of this (lane widths descend 4 -> 2 -> 1)
ARENA_ALIGN = 64

# the ingest ABI: order and dtypes mirror kArenaLanes in native/bamdecode.cpp
ARENA_SPEC = (
    ("cell", np.int32),
    ("umi", np.int32),
    ("gene", np.int32),
    ("qname", np.int32),
    ("ref", np.int32),
    ("pos", np.int32),
    ("nh", np.int32),
    ("ps", np.int32),
    ("genomic_qual", np.uint32),
    ("genomic_total", np.uint32),
    ("umi_qual", np.uint16),
    ("cb_qual", np.uint16),
    ("flags", np.int16),
    ("strand", np.int8),
    ("xf", np.int8),
    ("perfect_umi", np.int8),
    ("perfect_cb", np.int8),
    ("unmapped", np.bool_),
    ("duplicate", np.bool_),
    ("spliced", np.bool_),
)

# the two native-prepacked sections ride ReadFrame.extras; the rest are its
# per-record fields
_EXTRA_FIELDS = ("flags", "ps")
_FRAME_FIELDS = tuple(name for name, _ in ARENA_SPEC if name not in _EXTRA_FIELDS)


def arena_capacity(n: int) -> int:
    """The smallest valid capacity (a multiple of ARENA_ALIGN) >= ``n``."""
    if n < 1:
        raise ValueError(f"capacity must cover at least one record, got {n}")
    return -(-n // ARENA_ALIGN) * ARENA_ALIGN


def arena_nbytes(capacity: int) -> int:
    """The byte size of an arena of ``capacity`` records; equals
    ``native.arena_nbytes(capacity)``."""
    if capacity < 1 or capacity % ARENA_ALIGN:
        raise ValueError(f"capacity must be a positive multiple of {ARENA_ALIGN}, got {capacity}")
    return capacity * sum(np.dtype(dt).itemsize for _, dt in ARENA_SPEC)


class ColumnArena:
    """One pre-allocated packed column arena: one slot of the ring.

    The buffer is refilled batch after batch and ``frame()`` hands out views
    of it, so a frame of this arena is valid only until the arena is
    refilled: the ring's slot count gives the consumer a safe window, and
    anything kept longer must be copied (``io.packed.copy_frame``).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.nbytes = arena_nbytes(capacity)  # validates the capacity
        self.buf = np.empty(self.nbytes, dtype=np.uint8)
        # ``generation`` counts reclaims; ``slot`` is the ring's index of
        # this arena (the witness's label); ``poisoned`` marks a refill
        # window under the witness (both read by the ring's flight section)
        self.generation = 0
        self.poisoned = False
        self.slot: Optional[int] = None
        # the witness mode is read once, here, not once a batch
        self._debug = framedebug.enabled()
        self._views = {}
        offset = 0
        for name, dt in ARENA_SPEC:
            dt = np.dtype(dt)
            self._views[name] = np.frombuffer(self.buf, dtype=dt, count=capacity, offset=offset)
            offset += capacity * dt.itemsize

    def column(self, name: str) -> np.ndarray:
        """The full-capacity view of one section."""
        return self._views[name]

    def reclaim(self) -> None:
        """Recycle the slot: every frame of it goes stale.

        Bumps the generation (stamped frames of earlier generations fail
        their check) and, under ``SCTOOLS_TPU_FRAME_DEBUG=1``, fills the
        buffer with ``framedebug.POISON_BYTE``.
        """
        self.generation += 1
        if self._debug:
            self.buf[:] = framedebug.POISON_BYTE
            self.poisoned = True

    def fill(self, stream) -> int:
        """Write ``stream``'s current batch into this arena; returns its
        record count. ``stream`` is a ``native.NativeBatchStream`` whose
        ``next()`` decoded a batch. A refill is a recycle: the slot is
        reclaimed first."""
        self.reclaim()
        n = stream.fill_arena(self.buf, self.capacity)
        self.poisoned = False
        return n

    def pad_in_place(self, n: int, padded: int) -> None:
        """Fill rows [n:padded) of every section with its PAD_FILLS sentinel
        (0 for a section PAD_FILLS does not name)."""
        if not 0 <= n <= padded <= self.capacity:
            raise ValueError(f"pad window [{n}:{padded}) outside capacity {self.capacity}")
        for name, _ in ARENA_SPEC:
            self._views[name][n:padded] = PAD_FILLS.get(name, 0)

    def frame(
        self,
        n: int,
        cell_names: List[str],
        umi_names: List[str],
        gene_names: List[str],
        qname_names: Optional[List[str]] = None,
        batch_index: Optional[int] = None,
    ) -> ReadFrame:
        """A ReadFrame viewing rows [0:n) of this arena, ``flags`` and ``ps``
        in its extras; under ``SCTOOLS_TPU_FRAME_DEBUG=1`` a WitnessFrame
        stamped with this arena's generation (``batch_index`` labels it)."""
        if not 0 <= n <= self.capacity:
            raise ValueError(f"{n} records outside capacity {self.capacity}")
        kwargs = {name: self._views[name][:n] for name in _FRAME_FIELDS}
        kwargs["extras"] = {name: self._views[name][:n] for name in _EXTRA_FIELDS}
        kwargs.update(
            cell_names=cell_names,
            umi_names=umi_names,
            gene_names=gene_names,
            qname_names=qname_names if qname_names is not None else [""],
        )
        if self._debug:
            return framedebug.stamp_frame(kwargs, self, batch_index=batch_index)
        return ReadFrame(**kwargs)
