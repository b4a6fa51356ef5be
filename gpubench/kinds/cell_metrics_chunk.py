"""Traffic kind ``cell_metrics_chunk``: CalculateCellMetrics over one chunk.

Set-up makes a cell-sorted, tagged 10x library from the seed, writes it as
a BGZF BAM with the GTF of its MT- genes, reads the mitochondrial gene set
through the program's GTF reader (once, as a worker does for its chunks)
and runs one pass to warm the path. A pass is
``sctools_tpu_torch.metrics.gatherer.GatherCellMetrics(bam, stem,
mito).extract_metrics()``, the class ``CalculateCellMetrics`` runs: the
ring decodes the BAM, the card computes the metrics, the CSV is written.
Every pass writes its own CSV, and every CSV is checked after the window.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import numpy as np

from gpubench.core import log
from gpubench.gen import bam as gen
from gpubench.reference import cell_metrics as reference

UNITS = "records"
# float_gap: between the readings it was set from (PERF.md section 2): the
# program's float32 columns against the float64 reference read at most
# 2.5e-7 over the seeds tried on the card, the bfloat16 control 78.9
LIMITS = {"cells_wrong": 0, "counts_wrong": 0, "float_gap": 1e-2}


class State:
    pass


def _mito_names(names: np.ndarray, n_mito: int) -> set:
    """The GE values the configuration's GTF declares mitochondrial: gene
    names that start with ``MT-`` in any case (the GTF's gene_id equals its
    gene_name)."""
    return {bytes(name) for name in names[len(names) - n_mito:] if bytes(name).upper().startswith(b"MT-")}


def setup(ctx) -> State:
    from sctools_tpu_torch.gtf import get_mitochondrial_gene_names

    config = ctx.config
    begin = time.perf_counter()
    rng = np.random.default_rng(ctx.seed)
    state = State()
    state.config, state.work, state.device = config, ctx.work, ctx.device
    reads = gen.make_reads(rng, config["chunk_records"], config, ctx.traffic)
    state.reads = gen.sort_reads(reads, "cell")
    state.bam = ctx.work / "chunk.bam"
    state.qual = gen.write_tagged_bam(state.bam, rng, state.reads, config["read_length"])
    names = gen.gene_names(config["genes"], config["mito_genes"])
    state.mito = _mito_names(names, config["mito_genes"])
    gtf = ctx.work / "genes.gtf"
    gen.write_mito_gtf(gtf, names, config["mito_genes"])
    state.mito_ids = get_mitochondrial_gene_names(str(gtf))
    state.barcodes = int(np.unique(state.reads["cell"]).size)
    state.seconds: Dict[str, float] = {}
    made = time.perf_counter()
    _one_pass(state, ctx.work / "warm")  # the warm pass: the ring, the device pass's shapes, the CSV
    log(f"set-up: inputs and the mitochondrial genes {made - begin:.3f} s ({state.barcodes} barcodes), "
        f"warm pass {time.perf_counter() - made:.3f} s")
    state.csvs = []
    return state


def _one_pass(state, stem) -> None:
    from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics

    gatherer = GatherCellMetrics(str(state.bam), str(stem), state.mito_ids, device=state.device)
    gatherer.extract_metrics()
    for name, value in gatherer.seconds.items():
        state.seconds[name] = state.seconds.get(name, 0.0) + value


def build() -> None:
    """The port's native library (the ring's decode, the CSV), built on a
    checkout's first run and found built after it."""
    from sctools_tpu_torch import native

    native.ensure_built()


def units_per_pass(state) -> int:
    return state.config["chunk_records"]


def pass_counts(state) -> Dict[str, int]:
    """What a pass produces beside its records: one CSV row a barcode."""
    return {"barcodes": state.barcodes}


def run_pass(state, k: int) -> int:
    stem = state.work / f"pass_{k}"
    _one_pass(state, stem)
    state.csvs.append(f"{stem}.csv.gz")
    return state.config["chunk_records"]


def end_to_end(name: str, units: int, window_s: float):
    return units / window_s if name == "records_per_s" else None


def program_seconds(state) -> Dict[str, float]:
    return dict(state.seconds)


def program_launches() -> Dict[str, int]:
    from sctools_tpu_torch import kernels

    return dict(kernels.launches)


def span_targets():
    return [("sctools_tpu_torch.metrics.gatherer", "MetricGatherer.pack_batch", "bam.pack"),
            ("sctools_tpu_torch.ingest", "upload", "bam.upload"),
            ("sctools_tpu_torch.metrics.writer", "MetricCSVWriter.write_block", "bam.csv")]


def release(state) -> None:
    pass  # each pass's gatherer is gone with its pass


def _compare_all(state, want) -> Dict[str, float]:
    total = {"cells_wrong": 0, "counts_wrong": 0, "float_gap": 0.0}
    for path in state.csvs:
        try:
            numbers = reference.compare(want, *reference.read_csv(path))
        except OSError:
            numbers = {"cells_wrong": len(want), "counts_wrong": 0, "float_gap": math.inf}
        total["cells_wrong"] += numbers["cells_wrong"]
        total["counts_wrong"] += numbers["counts_wrong"]
        total["float_gap"] = max(total["float_gap"], numbers["float_gap"])
    return total


def check(state, passes) -> Dict[str, Tuple[float, float]]:
    import torch

    want = reference.table(state.reads, state.qual, state.mito, torch.float64)
    numbers = _compare_all(state, want)
    return {name: (numbers[name], LIMITS[name]) for name in LIMITS}


def control(state) -> Dict[str, Tuple[float, float]]:
    """The control: the reference computed in bfloat16, the precision below
    the float32 the configuration states, written as the CSV and compared."""
    import torch

    want = reference.table(state.reads, state.qual, state.mito, torch.float64)
    lower = reference.table(state.reads, state.qual, state.mito, torch.bfloat16)
    path = state.work / "control.csv.gz"
    reference.write_csv(str(path), lower)
    numbers = reference.compare(want, *reference.read_csv(str(path)))
    return {name: (numbers[name], LIMITS[name]) for name in LIMITS}
