"""The readers of the program's layer timers: ``bam.<part>`` (one generic
reader, ``metrics/bam.py``), the ``fastq.<part>`` names of the native
clocks (read by ``metrics/fastq.py``) and ``unnamed.<cells>``, on a
``core.Run`` as ``test_gpubench_readers.py`` builds one. A program without
a key (the parent of the timers) reads None, never raises."""

import math

from gpubench import core

LANE = {"open": 0.01, "read": 0.5, "correct": 0.25, "write": 1.0, "read.wait": 0.1, "inflate": 0.9,
        "write.wait": 0.2, "write.file": 0.05, "deflate": 3.2, "correct.wait": 0.2}
CHUNK = {"decode": 0.8, "decode.read": 0.01, "decode.inflate": 0.4, "decode.parse": 0.3, "decode.fill": 0.05,
         "start": 0.02, "decode_wait": 0.6, "pack": 0.1, "dispatch": 0.05, "wait": 0.01, "csv": 0.02,
         "close": 0.03, "carry": 0.04}


def run_of(seconds, units=1_000_000, window_s=2.0):
    return core.Run(cell="x", config={}, traffic={}, units=units, passes=2, window_s=window_s, seconds=seconds,
                    launches={}, counts={})


def read(name, run):
    metric = {"name": name}
    metric["reader"], metric["part"] = core.find_reader(name)
    return core.read_metric(metric, run)


def test_the_names_find_their_readers():
    assert core.find_reader("bam.decode.inflate")[1] == "decode.inflate"
    assert core.find_reader("bam.decode")[0].__name__.endswith("metrics.bam")
    assert core.find_reader("bam.decode_wait")[1] == ""  # its own file still reads it
    assert core.find_reader("fastq.write.file")[1] == "write.file"
    assert core.find_reader("unnamed.bam")[1] == "bam"


def test_bam_parts_per_mrecord():
    run = run_of(CHUNK, units=500_000)
    for part in ("decode", "decode.read", "decode.inflate", "decode.parse", "decode.fill"):
        assert math.isclose(read(f"bam.{part}", run), CHUNK[part] / 0.5)
    # the generic reader agrees with the older single-name one
    assert math.isclose(read("bam.decode_wait", run), CHUNK["decode_wait"] / 0.5)


def test_fastq_clock_names_per_mread():
    run = run_of(LANE, units=2_000_000)
    for part in ("read.wait", "inflate", "write.wait", "write.file", "deflate", "correct.wait"):
        assert math.isclose(read(f"fastq.{part}", run), LANE[part] / 2)


def test_unnamed_shares():
    assert math.isclose(read("unnamed.fastq", run_of(LANE)), 100 * (1 - 1.76 / 2))
    assert math.isclose(read("unnamed.bam", run_of(CHUNK)), 100 * (1 - 0.87 / 2))
    # the helper threads' keys and the parts never count
    assert math.isclose(read("unnamed.fastq", run_of(dict(LANE, deflate=50.0))), 100 * (1 - 1.76 / 2))


def test_a_program_without_the_keys_reads_none():
    parent = {"read": 0.5, "correct": 0.25, "write": 1.0, "decode": 0.8, "decode_wait": 0.6, "pack": 0.1,
              "dispatch": 0.05, "wait": 0.01, "csv": 0.02}
    run = run_of(parent)
    for name in ("bam.decode.read", "bam.decode.inflate", "bam.decode.parse", "bam.decode.fill",
                 "fastq.read.wait", "fastq.inflate", "fastq.write.wait", "fastq.write.file", "fastq.deflate",
                 "fastq.correct.wait", "unnamed.fastq", "unnamed.bam"):
        assert read(name, run) is None, name
    assert read("unnamed.other", run_of(CHUNK)) is None
    assert read("bam.decode", run_of(CHUNK, units=0)) is None
    assert read("unnamed.bam", run_of(CHUNK, window_s=0.0)) is None
