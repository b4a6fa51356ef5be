"""The processes of one run joined into one group (``torch.distributed``).

The JAX package keeps this inside ``jax.distributed`` and
``jax.experimental.multihost_utils``; the port keeps it here. A process
joins once (``initialize``) and holds two channels to its peers:

- **control**, a gloo group, always present: barriers and the host-side
  allgathers of counters and capacities (``process_allgather``);
- **the transport** for device tensors that cross processes, chosen from
  the topology at ``initialize`` and never changed afterwards: NCCL when
  every process's cards are distinct across the world (their UUIDs,
  allgathered over the control group), gloo when a card repeats across
  processes (NCCL refuses two ranks on one GPU) and on the CPU. A failed
  NCCL initialisation raises; nothing falls back to gloo.

``transport_device`` is where the transport's buffers live: this process's
first card on NCCL, the host on gloo. ``parallel.collective`` stages a
device tensor there before ``all_to_all_bytes`` and copies what it receives
to its shards' devices.

The group is one per process, as ``torch.distributed``'s default group is:
module state, set by ``initialize`` and cleared by ``shutdown``. Without a
group, this process is process 0 of 1, and ``process_allgather`` returns its
own value stacked.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve

DEFAULT_TIMEOUT = 300.0  # seconds a collective waits for a missing peer before it raises


class _Group:
    def __init__(self, rank: int, world: int, transport: str, device: torch.device, pg):
        self.rank = rank
        self.world = world
        self.transport = transport
        self.device = device
        self.pg = pg  # the transport's group (the default gloo group on gloo)


_GROUP: Optional[_Group] = None


def local_cards(device: DeviceLike = None) -> List[torch.device]:
    """This process's cards: ``device`` itself where it names an index,
    else every card ``torch.cuda`` sees."""
    resolved = resolve(device)
    if resolved.type != "cuda":
        raise ValueError(f"{resolved} is not a CUDA device")
    if resolved.index is not None:
        return [resolved]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device: DeviceLike = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> str:
    """Join this process, as rank ``process_id`` of ``num_processes``, to the
    group that ``coordinator_address`` (``host:port``, rank 0's) gathers.
    ``device``: ``cuda`` (every card, or the one card it names) unless the
    caller asks for ``cpu``. Returns the transport chosen, ``"nccl"`` or
    ``"gloo"``. Every collective of the group raises after ``timeout``
    seconds without its peers."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("this process already belongs to a process group")
    kind = resolve(device)
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=wait,
    )
    transport, home, pg = "gloo", torch.device("cpu"), dist.group.WORLD
    try:
        if kind.type == "cuda":
            cards = local_cards(kind)
            torch.cuda.set_device(cards[0])
            uuids = [str(torch.cuda.get_device_properties(card).uuid) for card in cards]
            world: List[List[str]] = [None] * num_processes
            dist.all_gather_object(world, uuids)
            every = [uuid for process in world for uuid in process]
            if len(set(every)) == len(every):
                transport, home = "nccl", cards[0]
                pg = dist.new_group(backend="nccl", timeout=wait, device_id=home)
                # the communicator is made here, so a broken NCCL raises at
                # initialisation and not at the first exchange
                probe = torch.ones(1, device=home)
                dist.all_reduce(probe, group=pg)
                if int(probe.item()) != num_processes:
                    raise RuntimeError(f"NCCL all_reduce over {num_processes} processes gave {probe.item()}")
    except BaseException:
        dist.destroy_process_group()
        raise
    _GROUP = _Group(process_id, num_processes, transport, home, pg)
    return transport


def shutdown() -> None:
    """Leave the group (every process calls it); a no-op without one."""
    global _GROUP
    if _GROUP is None:
        return
    _GROUP = None
    dist.destroy_process_group()


def process_index() -> int:
    return _GROUP.rank if _GROUP is not None else 0


def process_count() -> int:
    return _GROUP.world if _GROUP is not None else 1


def transport() -> Optional[str]:
    """``"nccl"`` or ``"gloo"``; None without a group."""
    return _GROUP.transport if _GROUP is not None else None


def transport_device() -> torch.device:
    """Where the transport's buffers live: a card on NCCL, the host on gloo."""
    return _require().device


def _require() -> _Group:
    if _GROUP is None:
        raise RuntimeError("no process group: call parallel.initialize_distributed first")
    return _GROUP


def process_allgather(x, tiled: bool = False) -> np.ndarray:
    """Every process's ``x`` (a host array of one shape and dtype on every
    process), in process order, over the control group: stacked on a new
    leading axis, or with ``tiled`` concatenated along axis 0 (JAX's
    ``multihost_utils.process_allgather``)."""
    x = np.asarray(x)
    if _GROUP is None:
        parts = [x]
    else:
        # the bytes travel, so every dtype (bool included) goes as it is
        mine = torch.from_numpy(np.frombuffer(np.ascontiguousarray(x).tobytes(), dtype=np.uint8).copy())
        gathered = [torch.empty_like(mine) for _ in range(_GROUP.world)]
        dist.all_gather(gathered, mine)
        parts = [np.frombuffer(t.numpy().tobytes(), dtype=x.dtype).reshape(x.shape) for t in gathered]
    return np.concatenate(parts) if tiled else np.stack(parts)


def all_gather_objects(value) -> list:
    """Every process's picklable ``value``, in process order (control group)."""
    if _GROUP is None:
        return [value]
    out = [None] * _GROUP.world
    dist.all_gather_object(out, value)
    return out


def all_to_all_bytes(send: torch.Tensor, send_splits: Sequence[int], recv_splits: Sequence[int]) -> torch.Tensor:
    """One exchange over the transport: ``send`` (uint8 on
    ``transport_device``) holds ``send_splits[p]`` bytes for process ``p``
    in process order; returns the bytes received, ``recv_splits[p]`` from
    each ``p`` in process order. Every process calls it together."""
    group = _require()
    recv = torch.empty(sum(recv_splits), dtype=torch.uint8, device=send.device)
    dist.all_to_all_single(recv, send, list(recv_splits), list(send_splits), group=group.pg)
    return recv
