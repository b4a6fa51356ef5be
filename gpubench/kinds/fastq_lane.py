"""Traffic kind ``fastq_lane``: FastqProcess -w over a lane of read triplets.

Set-up makes the whitelist and the lane's gzipped R1, R2 and I1 files from
the seed, builds one ``sctools_tpu_torch.fastqprocess.FastqProcess`` over
them (as a deployment loads its whitelist once for a lane) and runs one
pass to warm it. A pass is one ``run()``: every triplet read, its barcode
corrected on the card, the BAM shards written. Each pass's shards are moved
aside (a rename), so every pass's output is checked after the window.
"""

from __future__ import annotations

import hashlib
import os
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from gpubench.core import log
from gpubench.gen import fastq as gen
from gpubench.reference import bamread, whitelist as reference_whitelist
from gpubench.reference import fastq_lane as reference

UNITS = "reads"
LIMITS = {"reads_wrong": 0, "barcodes_split": 0, "counters_wrong": 0}


class State:
    pass


def setup(ctx) -> State:
    from sctools_tpu_torch.fastqprocess import FastqProcess

    config, traffic = ctx.config, ctx.traffic
    begin = time.perf_counter()
    rng = np.random.default_rng(ctx.seed)
    state = State()
    state.config, state.work = config, ctx.work
    state.whitelist = gen.make_whitelist(rng, config["whitelist_size"], config["barcode_length"])
    state.n = config["lane_reads"]
    state.triplets = gen.make_triplets(rng, state.whitelist, state.n, config, traffic)
    inputs = ctx.work / "inputs"
    inputs.mkdir()
    wl_path = inputs / "whitelist.txt"
    gen.write_whitelist(wl_path, state.whitelist)
    paths = gen.write_triplet_files(inputs, state.triplets, traffic["files_per_read"])
    state.out = ctx.work / "out"
    state.out.mkdir()
    made = time.perf_counter()
    state.fqp = FastqProcess(
        paths["r1"], paths["r2"], str(state.out / "shard"), cb_spans=[tuple(config["cb_span"])],
        umi_spans=[tuple(config["umi_span"])], sample_spans=[(0, config["i1_length"])], i1_files=paths["i1"],
        whitelist=str(wl_path), n_shards=config["n_shards"], output_format="BAM",
        sample_id=config["sample_id"], device=ctx.device)
    built = time.perf_counter()
    state.fqp.run()  # the warm pass: kernel, tables, thread pools, page cache
    log(f"set-up: inputs {made - begin:.3f} s, FastqProcess with its whitelist {built - made:.3f} s, "
        f"warm pass {time.perf_counter() - built:.3f} s")
    for path in state.out.iterdir():
        path.unlink()
    state.stats = []
    return state


def build() -> None:
    """The port's native library and whitelist kernel, built on a
    checkout's first run and found built after it."""
    from sctools_tpu_torch import kernels, native

    native.ensure_built()
    kernels.library("whitelist_correct")


def units_per_pass(state) -> int:
    return state.n


def pass_counts(state) -> Dict[str, int]:
    return {}


def run_pass(state, k: int) -> int:
    stats = state.fqp.run()
    os.rename(state.out, state.work / f"pass_{k}")
    state.out.mkdir()
    state.stats.append(stats)
    return state.n


def end_to_end(name: str, units: int, window_s: float):
    return units / window_s if name == "reads_per_s" else None


def program_seconds(state) -> Dict[str, float]:
    return dict(state.fqp.seconds)


def program_launches() -> Dict[str, int]:
    from sctools_tpu_torch import kernels

    return dict(kernels.launches)


def span_targets():
    return [("sctools_tpu_torch.ops.whitelist", "WhitelistCorrector.submit_block", "fastq.correct.submit"),
            ("sctools_tpu_torch.ops.whitelist", "PendingCorrection.indices", "fastq.correct.wait")]


def release(state) -> None:
    state.fqp = None


def _expected(state, tie: str = "last") -> dict:
    config = state.config
    lo, hi = config["cb_span"]
    table = reference_whitelist.Table(state.whitelist, tie=tie)
    index = table.correct(state.triplets["r1"][:, lo:hi])
    return reference.expected(state.triplets, state.whitelist, index, config["cb_span"], config["umi_span"])


def _digest(directory: Path) -> str:
    h = hashlib.sha256()
    for path in sorted(directory.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def check(state, passes) -> Dict[str, Tuple[float, float]]:
    """Every pass's shards against the reference; a pass whose files equal
    an already checked pass's, byte for byte, takes that pass's numbers."""
    want = _expected(state)
    total = dict.fromkeys(LIMITS, 0)
    done: Dict[str, Dict[str, int]] = {}
    for k in range(len(passes)):
        directory = state.work / f"pass_{k}"
        digest = _digest(directory)
        if digest not in done:
            shards = [bamread.read_bam(str(p)) for p in sorted(directory.glob("*.bam"))]
            done[digest] = reference.check(shards, want, state.stats[k])
        for name, value in done[digest].items():
            total[name] += value
    return {name: (total[name], LIMITS[name]) for name in LIMITS}


def control(state) -> Dict[str, Tuple[float, float]]:
    """The control: the reference with the stated tie rule broken (the first
    whitelist hit kept, not the last), written as shards and checked as the
    program's are."""
    wrong = _expected(state, tie="first")
    directory = state.work / "control"
    directory.mkdir(exist_ok=True)
    paths = reference.write_shards(directory, wrong, state.config["n_shards"])
    shards = [bamread.read_bam(p) for p in paths]
    numbers = reference.check(shards, _expected(state), wrong["counters"])
    return {name: (numbers[name], LIMITS[name]) for name in LIMITS}
