"""The port's layer timers: ``obs.timed``, the native clocks and the
profiler ranges.

Each layer of FastqProcess and of the metrics gatherer is timed once, into
the command's ``seconds`` under its key (``obs.timed``); the native layer
adds the parts it alone can see (the readahead's and the BGZF pool's waits,
the pool's deflate and writes, the BAM stream's file reads, inflate and
parse). Small runs on the CPU (a 256-barcode whitelist, three triplets of
1,500 reads in batches of 1,024; a 2,000-record tagged BAM in batches of 512
records) check:

- the keys of ``seconds`` and their meaning: the main thread's keys are
  positive and their sum is at most the run's wall time; each part is at
  most its parent (``read.wait`` of ``read``, ``correct.wait`` of
  ``correct``, ``write.wait`` + ``write.file`` of ``write``, the decode's
  four parts of ``decode``);
- with obs off and no profiler, no ``record_function`` is entered (it and
  torch's ``_RecordFunctionFast`` are patched to raise);
- under ``torch.profiler.profile(activities=[CPU])`` following every
  thread, the exported Chrome trace holds the ``scx.*`` ranges, and each
  key's ranges sum to its ``seconds`` within 5% or 1 ms;
- the BGZF pool's clocks in both output formats and with one thread, where
  the loop compresses every block itself inside ``write``;
- the ring's ``decode`` is its batches' spans, the terminating poll left
  out, on the arena path and through a ``source``;
- the JSON-lines sink's header gives the spans' zero on
  ``time.monotonic_ns()``;
- the cost of one ``obs.timed`` with nothing recording is printed (a
  microbenchmark, not asserted).
"""

from __future__ import annotations

import gzip
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sctools_tpu.bam import sort_by_tags_and_queryname
from sctools_tpu_torch import fastqprocess as port_fqp
from sctools_tpu_torch import native, obs
from sctools_tpu_torch.metrics import gatherer as port_gatherer

from helpers import write_bam
from test_metrics import random_tagged_records

BASES = np.array(list("ACGT"))
READS, FILES, BATCH = 1500, 3, 1024
RECORDS, BAM_BATCH = 2000, 512


def _fastq(path: Path, names, seqs, quals) -> str:
    text = "".join(f"@{n}\n{s}\n+\n{q}\n" for n, s, q in zip(names, seqs, quals))
    path.write_bytes(gzip.compress(text.encode()))
    return str(path)


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    """Three gzipped triplets and a 256-barcode whitelist: half the reads
    exact, a quarter one substitution away, a quarter random."""
    tmp = tmp_path_factory.mktemp("layer_timers_lane")
    rng = np.random.default_rng(7)
    whitelist = sorted({"".join(rng.choice(BASES, 16)) for _ in range(256)})
    (tmp / "wl.txt").write_text("\n".join(whitelist) + "\n")
    files = {"r1": [], "r2": [], "i1": []}
    for f in range(FILES):
        names = [f"read{f}_{i}" for i in range(READS)]
        r1 = []
        for i in range(READS):
            barcode = list(whitelist[int(rng.integers(len(whitelist)))])
            kind = i % 4
            if kind == 2:
                p = int(rng.integers(16))
                barcode[p] = "A" if barcode[p] != "A" else "C"
            elif kind == 3:
                barcode = list(rng.choice(BASES, 16))
            r1.append("".join(barcode) + "".join(rng.choice(BASES, 12)))
        r2 = ["".join(rng.choice(BASES, 91)) for _ in range(READS)]
        i1 = ["".join(rng.choice(BASES, 8)) for _ in range(READS)]
        for key, seqs in (("r1", r1), ("r2", r2), ("i1", i1)):
            quals = ["".join(chr(33 + int(q)) for q in rng.integers(2, 41, len(s))) for s in seqs]
            files[key].append(_fastq(tmp / f"{key}_{f}.fastq.gz", names, seqs, quals))
    return dict(files, whitelist=str(tmp / "wl.txt"))


def _fastq_process(lane, prefix, n_shards=3, output_format="BAM"):
    return port_fqp.FastqProcess(
        lane["r1"], lane["r2"], prefix, cb_spans=[(0, 16)], umi_spans=[(16, 28)], sample_spans=[(0, 8)],
        i1_files=lane["i1"], whitelist=lane["whitelist"], n_shards=n_shards, output_format=output_format,
        sample_id="s", batch_size=BATCH, device="cpu")


@pytest.fixture(scope="module")
def chunk(tmp_path_factory):
    """A cell-sorted tagged BGZF BAM of 2,000 records (the native arena path)."""
    tmp = tmp_path_factory.mktemp("layer_timers_chunk")
    records, header = random_tagged_records(seed=3, n_records=RECORDS, n_cells=12)
    return write_bam(str(tmp / "cell.bam"), list(sort_by_tags_and_queryname(records, ["CB", "UB", "GE"])),
                     header)


def _gather(chunk, stem):
    gatherer = port_gatherer.GatherCellMetrics(chunk, stem, batch_records=BAM_BATCH, device="cpu")
    gatherer.extract_metrics()
    return gatherer


def _check_lane_seconds(seconds, wall):
    assert set(seconds) == set(port_fqp.SECONDS)
    assert all(seconds[key] > 0 for key in port_fqp.MAIN_SECONDS)
    assert sum(seconds[key] for key in port_fqp.MAIN_SECONDS) <= wall
    assert all(value >= 0 for value in seconds.values())
    assert seconds["read.wait"] <= seconds["read"]
    assert seconds["correct.wait"] <= seconds["correct"]
    assert seconds["write.wait"] + seconds["write.file"] <= seconds["write"]
    assert seconds["inflate"] > 0 and seconds["deflate"] > 0 and seconds["write.file"] > 0


def _check_chunk_seconds(seconds, wall):
    assert set(seconds) == {"decode", *port_gatherer.ingest.DECODE_PARTS, *port_gatherer.MAIN_SECONDS}
    assert all(seconds[key] > 0 for key in port_gatherer.MAIN_SECONDS)
    assert sum(seconds[key] for key in port_gatherer.MAIN_SECONDS) <= wall
    parts = [seconds[key] for key in port_gatherer.ingest.DECODE_PARTS]
    assert all(part > 0 for part in parts)
    assert sum(parts) <= seconds["decode"]


def test_fastq_process_seconds_keep_their_meaning(lane, tmp_path):
    command = _fastq_process(lane, str(tmp_path / "out"))
    begin = time.perf_counter()
    stats = command.run()
    _check_lane_seconds(command.seconds, time.perf_counter() - begin)
    assert stats["total_reads"] == READS * FILES
    # the keys add up over runs
    first = dict(command.seconds)
    command.run()
    assert all(command.seconds[key] >= first[key] for key in first)
    assert command.seconds["read"] > first["read"]


def test_gatherer_seconds_keep_their_meaning(chunk, tmp_path):
    begin = time.perf_counter()
    gatherer = _gather(chunk, str(tmp_path / "cell"))
    _check_chunk_seconds(gatherer.seconds, time.perf_counter() - begin)
    assert gatherer.ring_batches > 1


def test_nothing_records_enters_no_range(lane, chunk, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with obs off and no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse, raising=False)
    assert not obs.enabled() and not obs._profiling()
    assert type(obs.timed({}, "x", "y")).__name__ == "_Timer" and obs.span("z") is obs._NOOP
    _fastq_process(lane, str(tmp_path / "out")).run()
    _gather(chunk, str(tmp_path / "cell"))


def _profile():
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    # every thread, so that the ring's thread is traced too
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _ranges(path) -> dict:
    events = json.loads(Path(path).read_text())["traceEvents"]
    sums = {}
    for event in events:
        if event.get("ph") == "X" and event.get("name", "").startswith("scx."):
            sums[event["name"]] = sums.get(event["name"], 0.0) + event["dur"] * 1e-6
    return sums


def _assert_ranges_match(ranges, seconds, where, keys):
    for key in keys:
        name = f"scx.{where}.{key}"
        assert name in ranges, (name, sorted(ranges))
        assert abs(ranges[name] - seconds[key]) <= max(0.05 * seconds[key], 1e-3), (name, ranges[name], seconds[key])


def test_profiler_ranges_sum_to_the_seconds(lane, chunk, tmp_path):
    command = _fastq_process(lane, str(tmp_path / "out"))
    with _profile() as prof:
        with torch.autograd.profiler.record_function("warm"):  # the first range's set-up
            pass
        command.run()
        gatherer = _gather(chunk, str(tmp_path / "cell"))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ranges = _ranges(tmp_path / "trace.json")
    _assert_ranges_match(ranges, command.seconds, "fastqprocess", port_fqp.MAIN_SECONDS + ("correct.wait",))
    _assert_ranges_match(ranges, gatherer.seconds, "gatherer", port_gatherer.MAIN_SECONDS)
    # the ring's decode runs on its own thread after the first batch
    _assert_ranges_match(ranges, gatherer.seconds, "ring", ("decode", "decode.fill"))
    # the spans of obs open their ranges too, with obs off
    assert not obs.enabled() and {"scx.upload", "scx.compute", "scx.writeback"} <= set(ranges)


def test_obs_span_records_and_times_once(tmp_path):
    seconds = {}
    obs.reset()
    obs.enable()
    try:
        with obs.timed(seconds, "decode", "ring", span="decode", records=3):
            pass
        with obs.timed(seconds, "fill", "ring"):
            pass
    finally:
        obs.disable()
    spans = obs.spans()
    obs.reset()
    assert [span["name"] for span in spans] == ["decode"] and spans[0]["attrs"] == {"records": 3}
    assert set(seconds) == {"decode", "fill"} and spans[0]["dur"] == seconds["decode"]


@pytest.mark.parametrize("output_format,threads", [("BAM", "4"), ("FASTQ", "4"), ("BAM", "1")])
def test_pool_clocks_see_the_blocks(lane, tmp_path, monkeypatch, output_format, threads):
    monkeypatch.setenv("SCTOOLS_TPU_THREADS", threads)
    command = _fastq_process(lane, str(tmp_path / "out"), n_shards=4, output_format=output_format)
    begin = time.perf_counter()
    command.run()
    seconds = command.seconds
    _check_lane_seconds(seconds, time.perf_counter() - begin)
    if threads == "1":
        # no workers: the loop compresses and writes every block inside write
        assert seconds["write.wait"] == 0
        assert seconds["deflate"] + seconds["write.file"] <= seconds["write"]


def _decode_spans(stats):
    spans = [span for span in obs.spans() if span["name"] == "decode"]
    batches = [span for span in spans if "eof" not in span.get("attrs", {})]
    assert len(spans) == len(batches) + 1 == stats["batches"] + 1
    assert sum(span["attrs"]["records"] for span in batches) == RECORDS
    assert stats["decode"] == pytest.approx(sum(span["dur"] for span in batches), rel=1e-9)


@pytest.mark.parametrize("path", ["arena", "source"])
def test_ring_decode_leaves_out_the_terminating_poll(chunk, path):
    from sctools_tpu_torch import ingest
    from sctools_tpu_torch.io.packed import DEFAULT_TAG_KEYS, _python_frames

    stats = {}
    decoded = list(_python_frames(chunk, BAM_BATCH, DEFAULT_TAG_KEYS)) if path == "source" else None
    obs.reset()
    obs.enable()
    try:
        if path == "arena":
            frames = ingest.ring_frames(chunk, BAM_BATCH, stats=stats)
        else:
            frames = ingest.ring_frames(source=iter(decoded), stats=stats)
        assert sum(frame.n_records for frame in frames) == RECORDS
        _decode_spans(stats)
    finally:
        obs.disable()
        obs.reset()


def test_stream_timers_grow(chunk):
    with native.NativeBatchStream(chunk) as stream:
        assert stream.timers() == dict.fromkeys(native.STREAM_TIMERS, 0.0)
        assert stream.next(BAM_BATCH) == BAM_BATCH
        first = stream.timers()
        while stream.next(BAM_BATCH):
            pass
        last = stream.timers()
    assert all(first[key] > 0 and last[key] >= first[key] for key in native.STREAM_TIMERS)


def test_sink_header_gives_the_zero_on_the_monotonic_clock(tmp_path):
    sink = tmp_path / "trace.jsonl"
    obs.reset()
    obs.enable(sink_path=str(sink))
    try:
        with obs.span("decode"):
            pass
        now = time.monotonic_ns()
    finally:
        obs.disable()
        obs.reset()
    header, record = [json.loads(line) for line in sink.read_text().splitlines()]
    assert header["meta"] == "clock" and isinstance(header["t0_monotonic_ns"], int)
    at = header["t0_monotonic_ns"] + record["ts"] * 1e9
    assert now - 1e9 < at <= now


def test_off_path_cost_of_one_timer(capsys):
    seconds, n = {}, 20_000
    begin = time.perf_counter()
    for _ in range(n):
        with obs.timed(seconds, "x", "bench"):
            pass
    timer_ns = (time.perf_counter() - begin) / n * 1e9
    begin = time.perf_counter()
    for _ in range(n):
        start = time.perf_counter()
        seconds["y"] = seconds.get("y", 0.0) + time.perf_counter() - start
    pair_ns = (time.perf_counter() - begin) / n * 1e9
    with capsys.disabled():
        print(f"\n[layer timers] one obs.timed with nothing recording: {timer_ns:.0f} ns "
              f"(a bare perf_counter pair and dict add: {pair_ns:.0f} ns)")
    assert seconds["x"] >= 0
