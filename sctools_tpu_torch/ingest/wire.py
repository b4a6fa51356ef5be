"""The device -> host boundary: ``pull``, and the writeback ring.

The port of ``sctools_tpu.ingest.wire``, the mirror of ``ingest.upload``:

- :func:`pull` is the one device -> host door. Every result that comes back
  to the host (the gatherers' writeback, the count's result blocks, the
  whitelist's indices, the mesh's pieces) goes through it, so each crossing
  lands in the transfer ledger (``obs.xprof``) once. It starts the copy of
  a tensor (or a list, tuple or dict of them) into pinned host memory with
  ``non_blocking=True`` on the tensor's own device and stream, records a
  CUDA event, and returns a :class:`Pulled` handle; ``Pulled.numpy()``
  waits for that one result. The wait is the asynchronous recovery
  boundary: a kernel's fault surfaces there, at the event, not at the
  launch. So the wait runs under the guard's transient ladder
  (``guard.retrying``) on the ``pull`` leg's deadline, or on the
  ``compute`` leg's when only that one is set: a transient there copies
  the device-resident tensor again in place (the handle keeps the device
  tensor alive until the copy has landed), and a poisoned or fatal
  computation re-raises to the caller. On the CPU nothing is copied or
  awaited, but the ladder runs all the same, so the fault grammar reaches
  every pull site.
- :class:`WritebackRing` keeps the slot accounting of the result blocks
  awaiting their copy: ``stage`` queues a batch's copy and records its
  event the moment its block exists (the copy runs while the next batch
  computes), and ``collect`` drains the blocks in FIFO order through the
  same guarded wait. ``SCTOOLS_TPU_WIRE_OVERLAP=0`` queues nothing at
  ``stage``, so that ``collect`` makes the whole copy; both give the same
  bytes. There is no fallback for a copy that fails: it raises. The ring's
  states are the ``writeback_slots`` flight section, and its phase is what
  the pulse heartbeat's writeback field samples.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, List, Optional, Tuple

import torch

from .. import guard, obs
from ..analysis.witness import make_lock
from ..obs import xprof

ENV_OVERLAP = "SCTOOLS_TPU_WIRE_OVERLAP"


def wire_overlap_enabled() -> bool:
    """Whether writeback rings queue each copy at stage time (default)
    instead of leaving the whole copy to the drain
    (``SCTOOLS_TPU_WIRE_OVERLAP=0``)."""
    return os.environ.get(ENV_OVERLAP, "") != "0"


def _leaves(value: Any) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [leaf for key in value for leaf in _leaves(value[key])]
    if isinstance(value, (list, tuple)):
        return [leaf for item in value for leaf in _leaves(item)]
    raise TypeError(f"pull takes tensors, or lists, tuples and dicts of them, not {type(value)}")


def _rebuild(value: Any, hosts: List[Any]) -> Any:
    """``value``'s structure with its leaves taken from ``hosts`` in order."""
    if isinstance(value, torch.Tensor):
        return hosts.pop(0)
    if isinstance(value, dict):
        return {key: _rebuild(item, hosts) for key, item in value.items()}
    return type(value)(_rebuild(item, hosts) for item in value)


def _queue_copy(tensor: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start ``tensor``'s copy into pinned host memory on the current
    stream of its own device (a mesh shard's result lives on its own
    card), and record the event that marks its end."""
    if tensor.device.type == "cpu":
        return tensor, None
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    with torch.cuda.device(tensor.device):
        host.copy_(tensor, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return host, event


def _land(copies) -> List[Any]:
    """Wait for each queued copy; the host arrays, in order."""
    hosts = []
    for host, event in copies:
        if event is not None:
            event.synchronize()
        hosts.append(host.numpy())
    return hosts


class Pulled:
    """A device result on its way to the host; ``numpy()`` waits for it.

    Holds the device tensors until their copy has landed, so that a
    transient at the wait can copy them again.
    """

    def __init__(self, value: Any, site: str = "", *, start: bool = True, name: str = "",
                 degrade_site: Optional[str] = None):
        self._value = value
        self._leaves = _leaves(value)
        self._copies = [_queue_copy(leaf) for leaf in self._leaves] if start else None
        self._host: Any = None
        self.site = site
        self.name = name
        self.degrade_site = degrade_site
        self.nbytes = sum(leaf.nbytes for leaf in self._leaves)

    def _get(self) -> Any:
        # the retried unit: the first attempt lands the copies queued at
        # pull or stage time; a retry (or a ring that queued nothing)
        # copies the device tensors again
        copies = self._copies if self._copies is not None else [_queue_copy(leaf) for leaf in self._leaves]
        self._copies = None
        return _rebuild(self._value, _land(copies))

    def numpy(self) -> Any:
        """The host value (numpy arrays in the pulled structure), once the
        copy has landed; the guarded wait runs once."""
        if self._host is None:
            # the wait's deadline: the pull leg when set, else the compute
            # leg's, so that a deployment that sets only the compute leg
            # keeps a wedged copy covered
            leg = "pull" if guard.watchdog.leg_timeout("pull") > 0 else "compute"
            self._host = guard.retrying(self._get, site=self.site, name=self.name, leg=leg,
                                        degrade_site=self.degrade_site)
            self._value = self._leaves = None  # the device blocks may go
        return self._host


def pull(value: Any, site: str, record: bool = True, wasted: int = 0,
         degrade_site: Optional[str] = None, name: str = "") -> Pulled:
    """Start the copy of ``value`` (a tensor, or a list, tuple or dict of
    tensors) to the host and return its :class:`Pulled` handle; its bytes
    go in the ledger under ``site``, ``wasted`` of them pad.

    ``degrade_site`` sends the strikes of a failed wait to the owning
    dispatch site, while faults, retry counters and the ledger stay on
    ``site``. ``record=False`` skips the ledger. The ledger's seconds stay
    0: the wait includes the computation's own time.
    """
    pulled = Pulled(value, site, name=name, degrade_site=degrade_site)
    if record:
        xprof.record_transfer("d2h", pulled.nbytes, site=site, wasted=wasted)
    return pulled


# ----------------------------------------------------- the writeback ring

# live writeback-ring state for flight records: ring id -> {...}, updated
# by the consumer thread; a postmortem reads it through the flight sections
_state_lock = make_lock("ingest.wire_state")
_ring_state: dict = {}
_ring_ids = itertools.count()

# death-path safe (obs.bounded_snapshot): the flight dump may run inside a
# signal handler that interrupted a state-update holder on this thread
_wire_snapshot = obs.bounded_snapshot(
    _state_lock,
    lambda: [dict(v, ring=k) for k, v in sorted(_ring_state.items())],
    [],
)

obs.register_flight_section("writeback_slots", _wire_snapshot)


class WritebackRing:
    """Slot accounting for device result blocks awaiting their copy.

    The download mirror of the decode ring's slots: the gatherers' pending
    queue owns order and depth; this class owns the copy queued at stage
    time and the slot states a postmortem sees. ``slots`` is the
    accounting width (pipeline depth plus the entry being staged or
    drained). FIFO by contract: ``collect`` drains the oldest staged batch,
    the order the pending queues pop, so the CSV's row order never depends
    on when a copy lands.
    """

    def __init__(self, name: str = "", slots: int = 4):
        self._id = next(_ring_ids)
        self._slots = max(1, int(slots))
        self._staged = 0
        self._drained = 0
        with _state_lock:
            _ring_state[self._id] = {
                "name": name,
                "slots": self._slots,
                "staged": 0,
                "drained": 0,
                "inflight": [],
                "phase": "idle",
            }

    def _update(self, **fields) -> None:
        with _state_lock:
            state = _ring_state.get(self._id)
            if state is not None:
                state.update(fields)

    def phase_code(self) -> int:
        """The current phase as the pulse's one-byte enum
        (:data:`sctools_tpu_torch.obs.pulse.WB_PHASES`), what a heartbeat
        carries so that a live reader sees where the writeback is."""
        from ..obs.pulse import WB_PHASES

        with _state_lock:
            state = _ring_state.get(self._id) or {}
            phase = state.get("phase", "idle")
        return WB_PHASES.get(phase, 0)

    def _inflight(self) -> list:
        return list(range(self._drained, self._staged))

    def stage(self, value: Any) -> Pulled:
        """Queue the copy of one batch's result block(s) and return its
        handle for :meth:`collect`. With overlap off nothing is queued and
        the whole copy happens in ``collect``."""
        overlap = wire_overlap_enabled()
        self._staged += 1
        self._update(staged=self._staged, inflight=self._inflight(),
                     phase="copying" if overlap else "staged")
        staged = Pulled(value, start=overlap)
        obs.count("wire_writeback_staged")
        return staged

    def collect(self, staged: Pulled, site: str, record: bool = True,
                wasted: int = 0, degrade_site: Optional[str] = None,
                name: str = "") -> Tuple[Any, int]:
        """Drain the oldest staged batch through the guarded wait ->
        ``(host value, bytes)``."""
        self._update(phase="draining")
        staged.site, staged.name, staged.degrade_site = site, name, degrade_site
        host = staged.numpy()
        if record:
            xprof.record_transfer("d2h", staged.nbytes, site=site, wasted=wasted)
        self._drained += 1
        self._update(drained=self._drained, inflight=self._inflight(), phase="idle")
        obs.count("wire_writeback_drained")
        return host, staged.nbytes

    def close(self) -> None:
        with _state_lock:
            _ring_state.pop(self._id, None)
