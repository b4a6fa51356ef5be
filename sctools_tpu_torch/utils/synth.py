"""Synthetic packed-record workloads for tests and dry runs.

The port's copy of ``sctools_tpu.utils.synth``: device-ready columnar
batches (the output format of ``io.packed`` frames padded as the metrics
engine takes them) made without file I/O, with ~10x-like cell, UMI and
gene cardinalities, the XF location mix, NH multi-mapping and duplicate and
spliced flags. The integer record columns are staged in an
``ingest.arena.ColumnArena`` (the packed buffer the native decoder fills),
padded in place with the shared PAD_FILLS policy and copied out before the
arena goes, as every frame that outlives its staging buffer is. The float
quality-summary columns are drawn directly. For the same seed the arrays
equal the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ingest.arena import ColumnArena, arena_capacity
from ..io.packed import pack_flags
from ..ops.segments import bucket_size

# the output columns that are also arena lanes: staged through the arena
_ARENA_STAGED = ("cell", "umi", "gene", "ref", "pos", "flags")


def make_synthetic_columns(
    n_records: int,
    n_cells: int = 64,
    n_genes: int = 32,
    n_umis: Optional[int] = None,
    seed: int = 0,
    pad: bool = True,
) -> Dict[str, np.ndarray]:
    """Random padded columns with the packed metric-engine schema.

    Codes are drawn uniformly; ``gene`` code 0 plays the "no GE tag" role
    (as the empty string sorts first in a vocabulary). Narrow per-record
    fields are packed into the int16 ``flags`` column as the gatherer packs
    them. Returns a dict ready for ``metrics.device.compute_entity_metrics``
    and ``parallel.shard.partition_columns``; deterministic per ``seed``.
    """
    rng = np.random.default_rng(seed)
    n_umis = n_umis if n_umis is not None else max(n_records // 4, 4)

    size = bucket_size(n_records) if pad else n_records
    valid = np.zeros(size, dtype=bool)
    valid[:n_records] = True

    # the staging arena: fresh per call, written once and copied out
    arena = ColumnArena(arena_capacity(max(size, 1)))

    def stage(name, draw):
        arena.column(name)[:n_records] = draw

    unmapped = rng.random(n_records) < 0.04
    stage("cell", rng.integers(0, n_cells, n_records))
    stage("umi", rng.integers(0, n_umis, n_records))
    stage("gene", rng.integers(0, n_genes, n_records))
    stage("ref", np.where(unmapped, -1, rng.integers(0, 4, n_records)))
    stage("pos", np.where(unmapped, -1, rng.integers(0, 100_000, n_records)))
    floats = {
        "umi_frac30": _padded(rng.random(n_records).astype(np.float32), size),
        "cb_frac30": _padded(rng.random(n_records).astype(np.float32), size),
        "genomic_frac30": _padded(rng.random(n_records).astype(np.float32), size),
        "genomic_mean": _padded((rng.random(n_records) * 40).astype(np.float32), size),
    }
    gene_codes = np.copy(arena.column("gene")[:n_records])
    # a fixed slice of genes is "mitochondrial"
    is_mito_gene = np.zeros(max(n_genes, 1), dtype=bool)
    is_mito_gene[: max(n_genes // 16, 1)] = True
    flags = pack_flags(
        strand=rng.integers(0, 2, n_records),
        unmapped=unmapped,
        duplicate=rng.random(n_records) < 0.15,
        spliced=rng.random(n_records) < 0.2,
        # XF codes (consts.XF_*): mostly CODING/INTRONIC/UTR, some
        # INTERGENIC and missing
        xf=rng.choice([0, 1, 2, 3, 4], size=n_records, p=[0.05, 0.6, 0.15, 0.1, 0.1]),
        perfect_umi=rng.choice([1, 1, 1, 0], size=n_records),
        perfect_cb=rng.choice([1, 1, 0, -1], size=n_records),
        nh=rng.choice([1, 1, 1, 2, 4], size=n_records),
        is_mito=is_mito_gene[gene_codes],
    )
    stage("flags", flags)
    # pad the staged lanes in place with the shared sentinel policy (these
    # columns all pad to 0, the padding rows the valid mask gates)
    arena.pad_in_place(n_records, size)

    cols = {name: np.copy(arena.column(name)[:size]) for name in _ARENA_STAGED}
    cols.update(floats)
    cols["valid"] = valid
    # the output order is part of the schema some callers zip over
    return {
        name: cols[name]
        for name in (
            "cell", "umi", "gene", "ref", "pos", "umi_frac30", "cb_frac30",
            "genomic_frac30", "genomic_mean", "valid", "flags",
        )
    }


def _padded(values: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros(size, dtype=values.dtype)
    out[: len(values)] = values
    return out
