"""CUDA graphs of the metrics engine's pass, captured once per signature.

The serve worker's counterpart of the JAX package's persistent compilation
cache and executable store: a resident replica should answer its first
request hot. Eagerly, ``metrics.device.compute_entity_metrics`` launches
about a thousand small kernels a batch, each paid for on the host; a
``torch.cuda.CUDAGraph`` records them once and replays them with one
launch.

One graph per static signature. The key is the engine's static arguments
(``num_segments``, ``kind``, ``presorted``, ``prepacked``, ``wide_genomic``,
``small_ref``, ``num_runs``, ``with_cb``: the ``static_argnames`` the graph
manifest (:mod:`.manifest`) lists for ``metrics.compute_entity_metrics``,
JAX's) plus the
name, shape and dtype of every input column. A batch's uploads are copied
into the graph's static input tensors and the graph is replayed; the call
returns the graph's static outputs. The next replay of that graph
overwrites them, so the caller reads them (the gatherer's compaction and
pull) before it queues another replay, in stream order.

Capture happens on first use: a few eager iterations on a side stream
(allocator and library workspaces settle there), then the capture. A key
is captured once: capturing it again raises :class:`GraphCaptureError`, as
a retrace is a failure of JAX's warm replica. A failed capture raises too;
there is no eager fallback on ``cuda``. A capture also proves the engine
free of host syncs (``.item()``, a data-dependent size): CUDA refuses
them while it records.

``captures`` and ``replays`` count what the set did. The set exists only on
``cuda``: a worker on the CPU runs the engine eagerly.

A capture is the port's compile: while tracing is on, each one records a
compile of the ``metrics.compute_entity_metrics`` site in ``obs.xprof``
(its host seconds as ``compile_s``), a second capture of one key records a
retrace before it raises, and each replay records one call of the site.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve
from ..guard.watchdog import shielded
from ..metrics import device as device_engine
from ..obs import xprof

#: the registry site a capture compiles
SITE = "metrics.compute_entity_metrics"

#: the engine's static arguments and their defaults (``compute_entity_metrics``)
STATIC_ARGS = (
    ("num_segments", None),
    ("kind", "cell"),
    ("presorted", False),
    ("prepacked", False),
    ("wide_genomic", False),
    ("small_ref", False),
    ("num_runs", 0),
    ("with_cb", True),
)

#: eager iterations on the side stream before a capture
WARMUP_ITERATIONS = 3


class GraphCaptureError(RuntimeError):
    """A graph key captured twice, or a capture that CUDA refused."""


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    outputs: Dict[str, torch.Tensor]


def graph_key(cols: Dict[str, torch.Tensor], kwargs: dict) -> Tuple:
    """The static signature of one engine call: its static arguments with
    their defaults filled in, and each input column's name, shape and
    dtype."""
    unknown = set(kwargs) - {name for name, _ in STATIC_ARGS}
    if unknown:
        raise TypeError(f"not a static argument of the engine: {sorted(unknown)}")
    static = tuple((name, kwargs.get(name, default)) for name, default in STATIC_ARGS)
    columns = tuple(
        (name, tuple(tensor.shape), str(tensor.dtype)) for name, tensor in cols.items()
    )
    return static, columns


class GraphSet:
    """The captured graphs of one worker, keyed by :func:`graph_key`."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a cuda device, not {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._graphs: Dict[Tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, cols: Dict[str, torch.Tensor], **kwargs) -> Dict[str, torch.Tensor]:
        """``compute_entity_metrics(cols, **kwargs)`` by graph replay: the
        graph of this signature, captured now if it is new."""
        key = graph_key(cols, kwargs)
        xprof.record_call(SITE, (cols,), kwargs)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self.capture(cols, **kwargs)
        else:
            for name, tensor in cols.items():
                entry.inputs[name].copy_(tensor, non_blocking=True)
        entry.graph.replay()
        self.replays += 1
        return entry.outputs

    def capture(self, cols: Dict[str, torch.Tensor], **kwargs) -> _Captured:
        """Capture the graph of this signature, with ``cols`` as its first
        inputs; the capture runs nothing (``run`` replays it)."""
        key = graph_key(cols, kwargs)
        if key in self._graphs:
            xprof.record_compile(SITE, xprof.signature((cols,), kwargs), retrace=True)
            raise GraphCaptureError(f"graph key captured twice: {key}")
        # the undecorated engine: warm-up and capture are no calls of the site
        engine = device_engine.compute_entity_metrics.__wrapped__
        start = time.perf_counter()
        # no Stall may land inside the warm-up or the capture: a capture cut
        # off mid-way leaves the stream capturing (guard.watchdog.shielded)
        with shielded(), torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            inputs = {name: tensor.clone() for name, tensor in cols.items()}
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERATIONS):
                    engine(inputs, **kwargs)
            current.wait_stream(side)
            # scx-lint: disable=SCX902 -- the capture is the compile; warmup captures every rung's keys before admission, and one that a key warmup missed makes while serving is counted (captures_serving) and held at 0 by the smoke
            graph = torch.cuda.CUDAGraph()
            try:
                # scx-lint: disable=SCX902 -- the same capture (see above)
                with torch.cuda.graph(graph):
                    outputs = engine(inputs, **kwargs)
            except Exception as error:
                raise GraphCaptureError(f"capture of {key} failed: {error}") from error
            # stored inside the shield: a Stall held over the capture lands
            # after it, and the guard's retry replays this graph
            entry = _Captured(graph, inputs, outputs)
            self._graphs[key] = entry
            self.captures += 1
            xprof.record_compile(SITE, xprof.signature((cols,), kwargs), time.perf_counter() - start)
        return entry
