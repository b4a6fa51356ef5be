"""The one spelling of the mesh collectives, over per-shard tensor lists.

The port of ``sctools_tpu.parallel.collective`` (parallel/collective.py:54-108).
A sharded value is a list of tensors in flat mesh order, shard *i* on
``mesh.devices[i]``; each collective takes one and returns one, every output
on its shard's device. ``axis_name`` is one mesh axis or a tuple of axes,
as in JAX: the shards that agree on every other axis form a group
(``Mesh.groups``), and a collective runs within each group.

Every output is a new tensor, built by ``torch.stack`` / ``torch.cat`` /
``torch.zeros`` over ``.to(device, non_blocking=True)`` copies, and never
written in place: on a mesh that repeats a card (or on the CPU) ``.to`` of a
tensor already on the target device returns that tensor, so an in-place
exchange would read what it has already overwritten. Between two cards,
PyTorch's device-to-device copy orders itself against both devices' current
streams with CUDA events; the host never waits.

JAX's scx-mesh witness (``analysis/meshwitness``) is not ported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .mesh import Mesh


def _check(xs: Sequence[torch.Tensor], mesh: Mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size} devices")


def _gathered(xs, mesh, group, dest) -> List[torch.Tensor]:
    """The group's shards, in axis order, copied to shard ``dest``'s device."""
    device = mesh.devices[dest]
    return [xs[i].to(device, non_blocking=True) for i in group]


def _reduce(xs, mesh, axis_name, reduce) -> List[torch.Tensor]:
    _check(xs, mesh)
    out: List[torch.Tensor] = [None] * mesh.size
    for group in mesh.groups(axis_name):
        for dest in group:
            out[dest] = reduce(torch.stack(_gathered(xs, mesh, group, dest)))
    return out


def psum(xs, mesh: Mesh, axis_name) -> List[torch.Tensor]:
    """Each shard gets the sum of its group's values, in their dtype (an
    integer sum wraps as int32 addition does; callers range-check first)."""
    return _reduce(xs, mesh, axis_name, lambda s: s.sum(0, dtype=s.dtype))


def pmean(xs, mesh: Mesh, axis_name) -> List[torch.Tensor]:
    return _reduce(xs, mesh, axis_name, lambda s: s.mean(0))


def pmax(xs, mesh: Mesh, axis_name) -> List[torch.Tensor]:
    return _reduce(xs, mesh, axis_name, lambda s: s.amax(0))


def pmin(xs, mesh: Mesh, axis_name) -> List[torch.Tensor]:
    return _reduce(xs, mesh, axis_name, lambda s: s.amin(0))


def all_gather(xs, mesh: Mesh, axis_name, axis: int = 0, tiled: bool = False) -> List[torch.Tensor]:
    """Each shard gets its group's values stacked along a new ``axis`` in
    axis order, or with ``tiled`` concatenated along ``axis``."""
    _check(xs, mesh)
    join = torch.cat if tiled else torch.stack
    out: List[torch.Tensor] = [None] * mesh.size
    for group in mesh.groups(axis_name):
        for dest in group:
            out[dest] = join(_gathered(xs, mesh, group, dest), dim=axis)
    return out


def all_to_all(xs, mesh: Mesh, axis_name, split_axis: int, concat_axis: int,
               tiled: bool = False) -> List[torch.Tensor]:
    """``jax.lax.all_to_all``: each shard splits its value along
    ``split_axis`` into one chunk per group member and sends chunk *j* to
    member *j*; each member joins what it received in source order along
    ``concat_axis``. With ``tiled`` the chunks are slabs and the join a
    concatenation; without, ``split_axis`` must have the group's size, each
    chunk drops it, and the join stacks along a new ``concat_axis``."""
    _check(xs, mesh)
    out: List[torch.Tensor] = [None] * mesh.size
    for group in mesh.groups(axis_name):
        n = len(group)
        chunks = []
        for i in group:
            size = xs[i].shape[split_axis]
            if (tiled and size % n) or (not tiled and size != n):
                raise ValueError(
                    f"all_to_all: split axis of size {size} does not split over {n} shards"
                )
            if tiled:
                chunks.append(torch.split(xs[i], size // n, dim=split_axis))
            else:
                chunks.append(torch.unbind(xs[i], dim=split_axis))
        join = torch.cat if tiled else torch.stack
        for j, dest in enumerate(group):
            device = mesh.devices[dest]
            out[dest] = join([c[j].to(device, non_blocking=True) for c in chunks], dim=concat_axis)
    return out


def ppermute(xs, mesh: Mesh, axis_name, perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Shard at axis index ``src`` sends its value to ``dst`` for each pair
    of ``perm``; a shard that receives nothing gets zeros."""
    _check(xs, mesh)
    out: List[torch.Tensor] = [None] * mesh.size
    for group in mesh.groups(axis_name):
        for dest in group:
            out[dest] = torch.zeros_like(xs[dest])
        for src, dst in perm:
            dest = group[dst]
            out[dest] = xs[group[src]].to(mesh.devices[dest], non_blocking=True, copy=True)
    return out


def axis_index(mesh: Mesh, axis_name) -> List[int]:
    """Each shard's index along ``axis_name`` (row-major over a tuple of
    axes), in flat mesh order: host integers, known without the device."""
    out = [0] * mesh.size
    for group in mesh.groups(axis_name):
        for position, shard in enumerate(group):
            out[shard] = position
    return out
