"""The traced window: ``torch.profiler`` on the host and the card, read back
from its Chrome trace.

Device work is every kernel, copy and fill on the card's timeline; the busy
time is the union of their intervals inside the harness's ``window`` span,
so work on two streams at once counts once. Idle gaps are the stretches of
the window outside that union, each labelled by the innermost harness span
(``spans.span``) open on the host at the gap's middle.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "gpubench."


class Tracer:
    def __init__(self, path: Path, on_card: bool):
        self.path = Path(path)
        self.on_card = on_card
        self._profile = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
        self._profile = profile(activities=activities)
        self._profile.__enter__()

    def stop(self) -> None:
        self._profile.__exit__(None, None, None)
        self._profile.export_chrome_trace(str(self.path))

    def summary(self) -> "Summary":
        with open(self.path) as f:
            return Summary(json.load(f))


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    return merged


class Summary:
    """The parts of one trace the readers use; times in seconds."""

    def __init__(self, trace: dict):
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in complete
                       if e.get("cat") in DEVICE_CATEGORIES]
        self.spans = [(e["name"][len(PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in complete if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)]
        window = [s for s in self.spans if s[0] == "window"]
        if window:
            self.lo, self.hi = window[0][1], window[0][2]
        else:
            times = [t for _, lo, hi in self.device + self.spans for t in (lo, hi)]
            self.lo, self.hi = (min(times), max(times)) if times else (0.0, 0.0)
        clipped = [(max(lo, self.lo), min(hi, self.hi)) for _, lo, hi in self.device]
        self.busy = union([(lo, hi) for lo, hi in clipped if hi > lo])

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy) / 1e6

    def device_s(self, contains: Optional[str] = None) -> float:
        """Seconds of device events (whose name holds ``contains``) inside
        the window, each counted whole."""
        return sum(min(hi, self.hi) - max(lo, self.lo) for name, lo, hi in self.device
                   if (contains is None or contains in name) and hi > self.lo and lo < self.hi) / 1e6

    def device_ops(self, n: int) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, lo, hi in self.device:
            if hi > self.lo and lo < self.hi:
                by_name[short_name(name)] += (min(hi, self.hi) - max(lo, self.lo)) / 1e6
        return [[name, seconds] for name, seconds in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        edges = [self.lo] + [t for lo, hi in self.busy for t in (lo, hi)] + [self.hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    def label(self, t: float) -> str:
        open_spans = [(hi - lo, name) for name, lo, hi in self.spans if lo <= t <= hi]
        return min(open_spans)[1] if open_spans else "outside any span"

    def idle_gaps(self, n: int) -> List[list]:
        """Idle seconds summed by the span open on the host at each gap's
        middle: [[label (gaps), seconds]], longest first."""
        total: Dict[str, float] = defaultdict(float)
        count: Dict[str, int] = defaultdict(int)
        for lo, hi in self.gaps():
            label = self.label((lo + hi) / 2)
            total[label] += (hi - lo) / 1e6
            count[label] += 1
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[f"{label} ({count[label]} gaps)", seconds] for label, seconds in ranked]
