"""The one spelling of the mesh collectives, over per-shard tensor lists.

The port of ``sctools_tpu.parallel.collective`` (parallel/collective.py:54-108).
A sharded value is a list of tensors in flat mesh order, shard *i* on
``mesh.devices[i]``; each collective takes one and returns one, every output
on its shard's device. ``axis_name`` is one mesh axis or a tuple of axes,
as in JAX: the shards that agree on every other axis form a group
(``Mesh.groups``), and a collective runs within each group.

On a mesh that spans processes (``Mesh.owners``) a list holds this
process's shards only: the others' entries are None on the way in and on
the way out. Every shard of a value has one shape and dtype, as in JAX, so
each process knows what it will receive without asking. A group that lies
inside one process exchanges by local copies; the pieces that cross
processes ride one ``distributed.all_to_all_bytes`` a collective, in an
order that every process derives from the mesh alone. Every process of the
group must therefore call the same collectives in the same order, and
whether one exchanges is decided from the mesh and never from the data
(SPMD), or the run waits on a missing peer until the group's timeout.

Every output is a new tensor, built by ``torch.stack`` / ``torch.cat`` /
``torch.zeros`` over ``.to(device, non_blocking=True)`` copies, and never
written in place: on a mesh that repeats a card (or on the CPU) ``.to`` of a
tensor already on the target device returns that tensor, so an in-place
exchange would read what it has already overwritten. Between two cards,
PyTorch's device-to-device copy orders itself against both devices' current
streams with CUDA events; the host never waits. Over NCCL the pieces are
staged on this process's transport card and the exchange is queued on the
device, so the host never waits there either. Over gloo (a card repeated
across processes, or the CPU) the pieces are staged through host memory
here: that copy to the host is the one host sync of a collective, and it
is the gloo route's only one. ``crossed`` counts the bytes this process has
sent to other processes, by collective.

JAX's scx-mesh witness (``analysis/meshwitness``) is not ported.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import distributed
from .mesh import Mesh

# bytes this process sent across the process boundary, by collective
crossed: collections.Counter = collections.Counter()

Cut = Callable[[torch.Tensor, int, int], torch.Tensor]


def _check(xs: Sequence[Optional[torch.Tensor]], mesh: Mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size} devices")
    missing = [i for i in mesh.local_shards if xs[i] is None]
    if missing:
        raise ValueError(f"no value for this process's shards {missing}")


def _whole(x: torch.Tensor, j: int, n: int) -> torch.Tensor:
    return x


def _exchange(xs, mesh: Mesh, axis_name, cut: Cut, name: str,
              pairs: Optional[Sequence[Tuple[int, int]]] = None, copy: bool = False
              ) -> Dict[int, Dict[int, torch.Tensor]]:
    """The pieces every local shard receives from its group, by sender's
    position: ``cut(x, j, n)`` is what a member holding ``x`` sends to
    member ``j`` of ``n``; ``pairs`` are the (sender, receiver) positions
    that send (default: every pair)."""
    _check(xs, mesh)
    owners, me = mesh.owners, mesh.process
    got: Dict[int, Dict[int, torch.Tensor]] = {dest: {} for dest in mesh.local_shards}
    crossing = []
    for group in mesh.groups(axis_name):
        n = len(group)
        for a, b in pairs if pairs is not None else [(a, b) for a in range(n) for b in range(n)]:
            src, dst = group[a], group[b]
            if owners[src] != owners[dst]:
                crossing.append((src, dst, a, b, n))
            elif owners[src] == me:
                got[dst][a] = cut(xs[src], b, n).to(mesh.devices[dst], non_blocking=True, copy=copy)
    if crossing:  # from the mesh alone, so every process of the group takes part
        _cross(xs, mesh, crossing, cut, name, got)
    return got


def _cross(xs, mesh: Mesh, crossing, cut: Cut, name: str, got) -> None:
    """The pieces of ``crossing`` (src, dst, a, b, n) that leave or reach this
    process, through one exchange over the transport."""
    owners, me = mesh.owners, mesh.process
    home = distributed.transport_device()
    on_card = home.type != "cpu"  # else gloo: staged through the host, a blocking copy
    sends: List[List[torch.Tensor]] = [[] for _ in range(distributed.process_count())]
    receives: List[List[Tuple[int, int]]] = [[] for _ in sends]
    for src, dst, a, b, n in crossing:
        if owners[src] == me:
            piece = cut(xs[src], b, n).contiguous().reshape(-1).view(torch.uint8)
            sends[owners[dst]].append(piece.to(home, non_blocking=on_card))
        elif owners[dst] == me:
            receives[owners[src]].append((dst, a))
    shape, dtype, nbytes = None, None, 0
    if mesh.local_shards:
        template = cut(xs[mesh.local_shards[0]], 0, crossing[0][4])
        shape, dtype = template.shape, template.dtype
        nbytes = math.prod(shape) * template.element_size()
    send_splits = [sum(p.numel() for p in pieces) for pieces in sends]
    flat = [p for pieces in sends for p in pieces]
    buffer = torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8, device=home)
    received = distributed.all_to_all_bytes(buffer, send_splits, [nbytes * len(r) for r in receives])
    crossed[name] += sum(send_splits)
    offset = 0
    for pieces in receives:
        for dst, a in pieces:
            piece = received[offset:offset + nbytes].view(dtype).reshape(shape)
            got[dst][a] = piece.to(mesh.devices[dst], non_blocking=on_card)
            offset += nbytes


def _joined(got, mesh: Mesh, join) -> List[Optional[torch.Tensor]]:
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for dest, pieces in got.items():
        out[dest] = join([pieces[a] for a in range(len(pieces))])
    return out


def _reduce(xs, mesh, axis_name, reduce, name) -> List[Optional[torch.Tensor]]:
    got = _exchange(xs, mesh, axis_name, _whole, name)
    return _joined(got, mesh, lambda pieces: reduce(torch.stack(pieces)))


def psum(xs, mesh: Mesh, axis_name) -> List[Optional[torch.Tensor]]:
    """Each shard gets the sum of its group's values, in their dtype (an
    integer sum wraps as int32 addition does; callers range-check first)."""
    return _reduce(xs, mesh, axis_name, lambda s: s.sum(0, dtype=s.dtype), "psum")


def pmean(xs, mesh: Mesh, axis_name) -> List[Optional[torch.Tensor]]:
    return _reduce(xs, mesh, axis_name, lambda s: s.mean(0), "pmean")


def pmax(xs, mesh: Mesh, axis_name) -> List[Optional[torch.Tensor]]:
    return _reduce(xs, mesh, axis_name, lambda s: s.amax(0), "pmax")


def pmin(xs, mesh: Mesh, axis_name) -> List[Optional[torch.Tensor]]:
    return _reduce(xs, mesh, axis_name, lambda s: s.amin(0), "pmin")


def all_gather(xs, mesh: Mesh, axis_name, axis: int = 0, tiled: bool = False) -> List[Optional[torch.Tensor]]:
    """Each shard gets its group's values stacked along a new ``axis`` in
    axis order, or with ``tiled`` concatenated along ``axis``."""
    join = torch.cat if tiled else torch.stack
    got = _exchange(xs, mesh, axis_name, _whole, "all_gather")
    return _joined(got, mesh, lambda pieces: join(pieces, dim=axis))


def all_to_all(xs, mesh: Mesh, axis_name, split_axis: int, concat_axis: int,
               tiled: bool = False) -> List[Optional[torch.Tensor]]:
    """``jax.lax.all_to_all``: each shard splits its value along
    ``split_axis`` into one chunk per group member and sends chunk *j* to
    member *j*; each member joins what it received in source order along
    ``concat_axis``. With ``tiled`` the chunks are slabs and the join a
    concatenation; without, ``split_axis`` must have the group's size, each
    chunk drops it, and the join stacks along a new ``concat_axis``."""
    _check(xs, mesh)
    n = mesh.axis_size(axis_name)
    for i in mesh.local_shards:
        size = xs[i].shape[split_axis]
        if (tiled and size % n) or (not tiled and size != n):
            raise ValueError(f"all_to_all: split axis of size {size} does not split over {n} shards")

    def cut(x, j, n):
        if tiled:
            width = x.shape[split_axis] // n
            return x.narrow(split_axis, j * width, width)
        return x.select(split_axis, j)

    join = torch.cat if tiled else torch.stack
    got = _exchange(xs, mesh, axis_name, cut, "all_to_all")
    return _joined(got, mesh, lambda pieces: join(pieces, dim=concat_axis))


def ppermute(xs, mesh: Mesh, axis_name, perm: Sequence[Tuple[int, int]]) -> List[Optional[torch.Tensor]]:
    """Shard at axis index ``src`` sends its value to ``dst`` for each pair
    of ``perm``; a shard that receives nothing gets zeros."""
    got = _exchange(xs, mesh, axis_name, _whole, "ppermute", pairs=perm, copy=True)
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for dest, pieces in got.items():
        out[dest] = next(iter(pieces.values())) if pieces else torch.zeros_like(xs[dest])
    return out


def axis_index(mesh: Mesh, axis_name) -> List[int]:
    """Each shard's index along ``axis_name`` (row-major over a tuple of
    axes), in flat mesh order: host integers, known without the device."""
    out = [0] * mesh.size
    for group in mesh.groups(axis_name):
        for position, shard in enumerate(group):
            out[shard] = position
    return out
