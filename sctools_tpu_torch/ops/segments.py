"""Sorted-segment primitives: lexicographic sort, run detection, reductions.

The port of ``sctools_tpu.ops.segments``: a record batch is a
struct-of-arrays, groups are *runs* of equal sort keys, and every
histogram/Counter becomes a segment reduction. Plain PyTorch ops on the
device of their inputs; nothing here syncs with the host (no ``.item()``, no
``torch.nonzero``, no boolean-mask indexing).

Padded (invalid) records must carry key values that sort after all real
records; reductions mask them out through the ``valid`` array.

The scatter-based ``segment_sum`` / ``segment_count`` / ``segment_min`` /
``first_index_per_segment`` of the JAX module are on neither the metrics nor
the count path (``ops/counting.py`` runs on ``RunBounds``) and are not
ported here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

_I32_MAX = torch.iinfo(torch.int32).max


def _pair_key(hi: torch.Tensor, lo: Optional[torch.Tensor]) -> torch.Tensor:
    """One int64 key ordered like the int32 pair (hi, lo).

    ``torch.sort`` takes one key. The high word keeps its sign; the low word
    is offset by 2^31 (the sign bit flipped, read unsigned), or a negative
    low operand would sort after the positives.
    """
    key = hi.to(torch.int64)
    if lo is None:
        return key
    return key * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def sort_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation that lexicographically sorts ``keys``.

    ``keys[0]`` is the most significant. The int32 keys pair up into int64
    keys (``_pair_key``), and stable sorts run from the least significant
    pair to the most, each on the order the previous left. Stable: tied
    records keep their record order (``jax.lax.sort`` with an iota operand,
    the JAX version, is not stable by contract).
    """
    pairs = [
        _pair_key(keys[i], keys[i + 1] if i + 1 < len(keys) else None)
        for i in range(0, len(keys), 2)
    ]
    perm = torch.sort(pairs[-1], stable=True).indices
    for key in reversed(pairs[:-1]):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def lexsort(
    keys: Sequence[torch.Tensor], values: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Sort ``values`` (and the keys) lexicographically by ``keys``.

    ``keys[0]`` is the most significant key. Returns (sorted_keys,
    sorted_values).
    """
    perm = sort_permutation(keys)
    return [k[perm] for k in keys], [v[perm] for v in values]


def _true(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


def run_starts(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boolean[N]: True where any key differs from the previous record.

    Position 0 is always a start.
    """
    first = keys[0]
    starts = torch.zeros(first.shape[0], dtype=torch.bool, device=first.device)
    starts[:1] = True
    for key in keys:
        changed = torch.cat([_true(1, key.device), key[1:] != key[:-1]])
        starts = starts | changed
    return starts


def segment_ids_from_starts(starts: torch.Tensor) -> torch.Tensor:
    """int32[N] run index for each record (0-based, nondecreasing)."""
    return (torch.cumsum(starts.to(torch.int32), 0) - 1).to(torch.int32)


def run_is_singleton(starts: torch.Tensor) -> torch.Tensor:
    """True at run starts whose run holds exactly one record (the next
    record starts a new run, or the array ends)."""
    next_is_start = torch.cat([starts[1:], _true(1, starts.device)])
    return starts & next_is_start


def run_is_plural(starts: torch.Tensor) -> torch.Tensor:
    """True at run starts whose run holds more than one record."""
    next_is_start = torch.cat([starts[1:], _true(1, starts.device)])
    return starts & ~next_is_start


def _scan(values: torch.Tensor, starts: torch.Tensor, fill, combine) -> torch.Tensor:
    """The unrolled Hillis-Steele segmented scan both scans share.

    At stride d = 1, 2, 4, ... < N each position folds in its d-back
    neighbour unless a run boundary lies between them; out-of-window
    neighbours contribute ``fill``. The stride order is the f32 combine
    order of the JAX version, so float totals come out bit for bit equal
    (a cumsum or another tree would change bits).
    """
    n = values.shape[0]
    two_d = values.dim() == 2
    value = values
    blocked = starts  # True once a run boundary lies within the window
    stride = 1
    while stride < n:
        head = torch.full(
            (stride,) + tuple(value.shape[1:]), fill,
            dtype=value.dtype, device=value.device,
        )
        prev_value = torch.cat([head, value[:-stride]])
        prev_blocked = torch.cat([_true(stride, blocked.device), blocked[:-stride]])
        gate = blocked[:, None] if two_d else blocked
        value = combine(value, torch.where(gate, fill, prev_value))
        blocked = blocked | prev_blocked
        stride *= 2
    return value


def segmented_scan_sum(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive running sums that reset at run starts.

    ``values`` is [N] or [N, C]; ``starts`` the run-start flags. Partial sums
    stay run-local, so int32 columns are exact and no value ever mixes
    across runs.
    """
    return _scan(values, starts, 0, torch.add)


def segmented_scan_min(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Inclusive running minimum that resets at run starts.

    ``values`` is [N] or [N, C] integer; out-of-run neighbours contribute
    the dtype maximum.
    """
    return _scan(values, starts, torch.iinfo(values.dtype).max, torch.minimum)


class RunBounds:
    """Boundary view of a sorted segmentation: run s = [start[s], next[s]).

    The run-start positions are compacted into slot order (unused slots
    collapse to the empty span [n, n)); every reduction is then a segmented
    scan plus a row gather at the run-end positions. The JAX version
    compacts with a one-operand sort of ``where(starts, iota, n)``; this one
    scatters each start to its slot (the cumsum of the starts) instead, which
    gives the same array with no sort and no host sync.
    """

    def __init__(self, starts: torch.Tensor):
        n = starts.shape[0]
        device = starts.device
        iota = torch.arange(n, dtype=torch.int32, device=device)
        slot = segment_ids_from_starts(starts).to(torch.int64)
        # non-starts all land in the spare slot n, which is dropped
        target = torch.where(starts, slot, n)
        start_pos = torch.full((n + 1,), n, dtype=torch.int32, device=device)
        self.start_pos = start_pos.scatter_(0, target, iota)[:n]
        self.next_pos = torch.cat(
            [self.start_pos[1:], torch.full((1,), n, dtype=torch.int32, device=device)]
        )
        self.starts = starts
        self.n = n
        self.used = self.start_pos < n

    def _last(self) -> torch.Tensor:
        return torch.clamp(self.next_pos - 1, 0, self.n - 1).to(torch.int64)

    def sum(self, columns: torch.Tensor) -> torch.Tensor:
        """Per-run totals of [N] / [N, C] columns; zeros on unused slots.

        Callers apply masks by zeroing rows beforehand.
        """
        scanned = segmented_scan_sum(columns, self.starts)
        totals = scanned[self._last()]
        used = self.used[:, None] if columns.dim() == 2 else self.used
        return torch.where(used, totals, torch.zeros((), dtype=totals.dtype, device=totals.device))

    def first(self, values: torch.Tensor, fill) -> torch.Tensor:
        """The value at each run's first record (``fill`` on unused slots)."""
        idx = torch.clamp(self.start_pos, max=self.n - 1).to(torch.int64)
        return torch.where(self.used, values[idx], fill)

    def min(self, values: torch.Tensor, fill) -> torch.Tensor:
        """Per-run minimum of an integer column (``fill`` on unused slots)."""
        scanned = segmented_scan_min(values, self.starts)
        return torch.where(self.used, scanned[self._last()], fill)


def pad_to(n: int, multiple: int) -> int:
    """Smallest padded size >= n that is a multiple of ``multiple`` (min 1)."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


# the record floor under ``bucket_size`` and the entity floor under
# ``entity_bucket``; the JAX package's values, so both packages pad every
# batch and every pull to the same shapes
RECORD_BUCKET_MIN = 4096
ENTITY_BUCKET_MIN = 64


def bucket_size(n: int, minimum: Optional[int] = None) -> int:
    """Power-of-two padded size >= max(n, minimum).

    Bucketing record counts to powers of two bounds the number of distinct
    shapes while wasting at most 2x. ``minimum`` defaults to
    ``RECORD_BUCKET_MIN``, read at call time.
    """
    size = RECORD_BUCKET_MIN if minimum is None else minimum
    while size < n:
        size *= 2
    return size


def entity_bucket(n_entities: int, cap: int) -> int:
    """Pow2 bucket for an entity-count-sized device slice, capped at the
    (already bucketed) padded record count ``cap``."""
    return min(bucket_size(n_entities, minimum=ENTITY_BUCKET_MIN), cap)
