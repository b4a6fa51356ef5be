"""The trace summary and the per-layer readers on a profiler fixture.

``fixtures/trace_fastq.json`` has the shape of ``torch.profiler``'s Chrome
trace: a 10 ms window, two passes, two whitelist kernels, a copy that
overlaps the first kernel, a fill, device work before the window, and a
device-side copy of a harness annotation (which is no device work)."""

import json
import math
from pathlib import Path

import pytest

from gpubench import core, trace, work

FIXTURE = Path(__file__).parent / "fixtures" / "trace_fastq.json"


@pytest.fixture()
def summary():
    return trace.Summary(json.loads(FIXTURE.read_text()))


def run_of(summary, **over):
    base = dict(cell="fastq-10xv3", config={"barcode_length": 16, "cells": 10}, traffic={}, units=131072,
                passes=2, window_s=0.01, seconds={"read": 0.5, "correct": 0.25, "write": 1.0, "decode_wait": 0.1,
                                                  "pack": 0.02, "dispatch": 0.03},
                launches={"whitelist_correct": 2}, counts={"barcodes": 20}, trace=summary,
                device_name="NVIDIA H100 80GB HBM3")
    base.update(over)
    return core.Run(**base)


class reader:
    """The reader the harness finds for a metric, called as the harness does."""

    def __init__(self, name):
        self.metric = {"name": name}
        self.metric["reader"], self.metric["part"] = core.find_reader(name)

    def read(self, run):
        return core.read_metric(self.metric, run)


def test_union_window_and_gaps(summary):
    assert math.isclose(summary.window_s, 0.01)
    # the copy 2050-2150 overlaps the kernel 2100-2400: 350 us, then 300 and 50
    assert math.isclose(summary.busy_s, 700e-6)
    assert math.isclose(summary.device_s("whitelist_correct"), 600e-6)
    ops = dict(summary.device_ops(10))
    assert math.isclose(ops["whitelist_correct_kernel"], 600e-6)
    assert "vectorized_elementwise_kernel" not in ops  # before the window
    gaps = dict(summary.idle_gaps(10))
    assert math.isclose(sum(gaps.values()), 0.01 - 700e-6)
    assert set(gaps) == {"pass (3 gaps)", "fastq.correct.wait (1 gaps)"}


def test_readers(summary):
    run = run_of(summary)
    assert math.isclose(reader("fastq.read").read(run), 0.5 / 0.131072)
    assert math.isclose(reader("fastq.correct").read(run), 0.25 / 0.131072)
    assert math.isclose(reader("fastq.write").read(run), 1.0 / 0.131072)
    assert math.isclose(reader("whitelist_correct.ms").read(run), 0.3)
    floor_s = 131072 * 20 / 3.35e12
    assert math.isclose(reader("whitelist_correct_roofline").read(run), 100 * floor_s / 600e-6)
    assert math.isclose(reader("device_idle.fastq").read(run), 93.0)
    assert math.isclose(reader("device_idle.bam").read(run), 93.0)
    assert math.isclose(reader("bam.decode_wait").read(run), 0.1 / 0.131072)
    assert math.isclose(reader("bam.pack").read(run), 0.05 / 0.131072)
    assert math.isclose(reader("metrics_pass.ms").read(run), 0.7 / 0.131072)
    want = work.metrics_pass_bytes(131072, 20) / 3.35e12 / 700e-6 * 100
    assert math.isclose(reader("metrics_pass_roofline").read(run), want)


def test_readers_find_nothing_and_say_so(summary):
    empty = trace.Summary({"traceEvents": []})
    run = run_of(empty, launches={"whitelist_correct": 0}, seconds={})
    for name in ("fastq.read", "whitelist_correct.ms", "whitelist_correct_roofline", "device_idle.fastq",
                 "bam.pack", "metrics_pass.ms", "metrics_pass_roofline"):
        assert reader(name).read(run) is None, name
    # an unknown card has no published peak: no roofline share, never 0
    assert reader("whitelist_correct_roofline").read(run_of(summary, device_name="cpu")) is None
    assert reader("whitelist_correct.ms").read(run_of(summary, trace=None)) is None


def test_readers_are_found_by_name_or_its_leading_part():
    device_idle, part = core.find_reader("device_idle.bam")
    assert device_idle.__file__.endswith("device_idle.py") and part == "bam"
    assert core.find_reader("device_idle.fastq")[0].__file__ == device_idle.__file__
    fastq, part = core.find_reader("fastq.write")
    assert fastq.__file__.endswith("fastq.py") and part == "write"
    pack, part = core.find_reader("bam.pack")
    assert pack.__file__.endswith("bam.pack.py") and part == ""
    with pytest.raises(core.Refused):
        core.find_reader("no_such_metric.x")


def test_short_names():
    assert trace.short_name("void at::native::(anonymous namespace)::fill<int>(int, float)") == "at::native::fill"
