"""The device mesh: an ordered list of ``torch.device``s with named axes.

The port of ``sctools_tpu.parallel.mesh`` (parallel/mesh.py:24-164). The
JAX mesh is one process driving N devices under ``shard_map``; the port's is
the same host loop over a list of devices. Shard *i* of every sharded value
lives on ``mesh.devices[i]``, and the collectives of ``.collective`` are
explicit copies between those devices.

A mesh may span processes (``global_mesh``, the port of ``jax.devices()``
after ``jax.distributed.initialize``): N processes x D local devices, in
process-major order, process p owning flat shards [p*D, (p+1)*D).
Ownership is explicit (``Mesh.owners``), since two processes may name the
same card; a process holds and computes only its ``local_shards``, and the
collectives exchange the rest through ``.distributed``. A mesh built
without owners belongs wholly to the process that built it.

``make_mesh`` takes its devices from ``device`` (``cuda`` unless the caller
asks for ``cpu``): ``cuda:0 … cuda:N-1``, or N CPU shards, the counterpart
of the JAX tests' forced host device count. An explicit ``devices`` list may
repeat a card, so that two shards run on one GPU; no command builds such a
mesh.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from . import distributed

DEFAULT_AXIS = "shard"
DCN_AXIS = "dcn"


class Mesh:
    """Devices laid out on named axes, row-major: flat shard ``i`` sits at
    ``np.unravel_index(i, sizes)``, lives on ``devices[i]`` and belongs to
    process ``owners[i]`` (default: every shard to ``process``, this
    process's index)."""

    def __init__(self, devices: Sequence[torch.device], axis_names: Sequence[str],
                 sizes: Optional[Sequence[int]] = None, owners: Optional[Sequence[int]] = None,
                 process: Optional[int] = None):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        sizes = tuple(sizes) if sizes is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names) or math.prod(sizes) != len(self.devices):
            raise ValueError(
                f"{len(self.devices)} devices do not fill axes {self.axis_names} of sizes {sizes}"
            )
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = len(self.devices)
        self.process = distributed.process_index() if process is None else process
        self.owners: Tuple[int, ...] = tuple(owners) if owners is not None else (self.process,) * self.size
        if len(self.owners) != self.size:
            raise ValueError(f"{len(self.owners)} owners for {self.size} devices")
        self.local_shards: List[int] = [i for i, owner in enumerate(self.owners) if owner == self.process]
        self.is_fully_addressable = len(self.local_shards) == self.size

    def groups(self, axis_name) -> List[List[int]]:
        """The flat shard indices that communicate over ``axis_name`` (one
        axis or a tuple of axes), one list per group, each in axis-index
        order: shards that agree on every other axis form a group."""
        axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        for axis in axes:
            if axis not in self.shape:
                raise ValueError(f"mesh has no axis {axis!r}; its axes are {self.axis_names}")
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        others = [i for i, name in enumerate(self.axis_names) if name not in axes]
        inner = [self.axis_names.index(axis) for axis in axes]
        width = math.prod(self.shape[axis] for axis in axes)
        return grid.transpose(others + inner).reshape(-1, width).tolist()

    def axis_size(self, axis_name) -> int:
        axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
        return math.prod(self.shape[axis] for axis in axes)

    def __repr__(self) -> str:
        devices = ", ".join(str(d) for d in self.devices)
        owners = "" if self.is_fully_addressable else f", owners={list(self.owners)}, process={self.process}"
        return f"Mesh(axes={self.shape}, devices=[{devices}]{owners})"


def _available(device: DeviceLike) -> List[torch.device]:
    """Every device of ``device``'s type this process may use: the CUDA
    cards, or one CPU shard per core."""
    kind = resolve(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = DEFAULT_AXIS,
    devices: Optional[Sequence] = None,
    device: DeviceLike = None,
) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices of ``devices``, or
    of every device of ``device``'s type (``cuda`` unless the caller asks
    for ``cpu``). Too few devices raise JAX's ``ValueError``."""
    devices = list(devices) if devices is not None else _available(device)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def global_mesh(axis_name: str = DEFAULT_AXIS, device: DeviceLike = None,
                devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over every process's local devices, process-major: process
    p owns global shards [p*D, (p+1)*D). The local devices are ``devices``
    (as ``make_mesh`` takes them, e.g. two CPU shards), else every card on
    ``cuda`` or one CPU shard on ``cpu``. Every process of the group calls
    it; unequal local counts raise on every process. Without a group it is
    this process's own mesh."""
    if devices is None:
        devices = distributed.local_cards(device) if resolve(device).type == "cuda" else [torch.device("cpu")]
    local = [str(torch.device(d)) for d in devices]
    everyone = distributed.all_gather_objects(local)
    counts = [len(process) for process in everyone]
    if len(set(counts)) != 1:
        raise ValueError(f"processes hold unequal local device counts {counts}: a global mesh needs equal ones")
    flat = [torch.device(d) for process in everyone for d in process]
    owners = [p for p, process in enumerate(everyone) for _ in process]
    return Mesh(flat, (axis_name,), owners=owners)


def make_hybrid_mesh(
    n_slices: int,
    devices_per_slice: Optional[int] = None,
    ici_axis: str = DEFAULT_AXIS,
    dcn_axis: str = DCN_AXIS,
    devices=None,
    device: DeviceLike = None,
) -> Mesh:
    """A 2-D ``(dcn, ici)`` mesh: slices x devices per slice, row-major
    over ``devices`` (or every device of ``device``'s type). ``devices`` may
    be a mesh, whose devices and owners it takes: over ``global_mesh()``,
    ``make_hybrid_mesh(process_count())`` is (processes, local devices),
    JAX's layout once ``jax.devices()`` is global."""
    owners = process = None
    if isinstance(devices, Mesh):
        devices, owners, process = list(devices.devices), list(devices.owners), devices.process
    devices = list(devices) if devices is not None else _available(device)
    if devices_per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(f"{len(devices)} devices do not divide into {n_slices} slices")
        devices_per_slice = len(devices) // n_slices
    need = n_slices * devices_per_slice
    if need > len(devices):
        raise ValueError(f"requested {need} devices, only {len(devices)} available")
    return Mesh(devices[:need], (dcn_axis, ici_axis), (n_slices, devices_per_slice),
                owners=owners[:need] if owners is not None else None, process=process)


def mesh_fingerprint(mesh: Mesh) -> dict:
    """The comparability key of a mesh: axis names, sizes and device kind
    (read from this process's first shard, the kind of every shard)."""
    if not mesh.local_shards:
        kind = "unknown"
    elif mesh.devices[mesh.local_shards[0]].type == "cuda":
        kind = torch.cuda.get_device_name(mesh.devices[mesh.local_shards[0]])
    else:
        kind = "cpu"
    return {
        "axes": list(mesh.axis_names),
        "sizes": list(mesh.shape.values()),
        "devices": mesh.size,
        "device_kind": kind,
    }


def collective_preflight(mesh: Mesh, axis_name: str = DEFAULT_AXIS) -> dict:
    """Prove the mesh's collectives on a known payload before real data.

    Each shard holds row ``axis_index`` of ``arange(n * 4).reshape(n, 4)``;
    one ``psum`` of the row sums, one ``all_gather`` of the rows and one
    ``all_to_all`` of each row sum repeated n times must conserve it. A mesh
    whose copies drop or duplicate elements fails here, not in a merge. On a
    mesh that spans processes every process calls it and checks its own
    shards. Returns ``{"devices", "total"}``.
    """
    from .. import ingest
    from . import collective

    n = mesh.axis_size(axis_name)
    block = np.arange(n * 4, dtype=np.int32).reshape(n, 4)
    index = collective.axis_index(mesh, axis_name)
    rows = [ingest.upload(block[index[i]], mesh.devices[i]) if i in mesh.local_shards else None
            for i in range(mesh.size)]
    sums = [r.sum(dtype=torch.int32) if r is not None else None for r in rows]
    totals = collective.psum(sums, mesh, axis_name)
    gathered = collective.all_gather(rows, mesh, axis_name)
    fanout = [s.repeat(n) if s is not None else None for s in sums]
    exchanged = collective.all_to_all(fanout, mesh, axis_name, 0, 0)
    # every local shard's view: its total, and the gather and exchange it received
    pulls = [
        ingest.pull(torch.cat([totals[i].reshape(1), gathered[i].reshape(-1), exchanged[i].reshape(-1)]))
        for i in mesh.local_shards
    ]
    views = [pulled.numpy() for pulled in pulls]
    expected = int(block.sum())
    totals = [int(view[0]) for view in views]
    # all_to_all: a shard receives one row sum from each of the n shards
    row_sums = np.asarray([int(view[1 + n * 4 :].sum()) for view in views])
    gathers_ok = all(np.array_equal(view[1 : 1 + n * 4].reshape(n, 4), block) for view in views)
    if set(totals) != {expected} or not gathers_ok or not np.all(row_sums == expected):
        raise RuntimeError(
            f"collective preflight failed on mesh {mesh!r}: psum total "
            f"{totals[0] if set(totals) == {totals[0]} else totals} (expected {expected}), "
            f"all_to_all row sums {row_sums.tolist()} — the mesh's collectives drop "
            "or duplicate elements; do not serve batches on it"
        )
    return {"devices": n, "total": expected}
