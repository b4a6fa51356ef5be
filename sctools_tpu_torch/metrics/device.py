"""The metrics engine on the device: cell/gene QC as sorted-segment reductions.

The port of ``sctools_tpu.metrics.device`` as plain PyTorch ops on the device
of their inputs. One pass over a padded record batch:

1. group structure comes from *runs* of equal tag keys. The gatherer's input
   is sorted by the tag triple, so with ``presorted=True`` no primary sort
   happens: run detection works in record order. ``presorted=False`` first
   applies one 3-key sort permutation;
2. ONE key-only auxiliary sort realizes every histogram at once. Its key
   order is (outer, pair, inner): (cell, gene|mito, umi) for the cell axis,
   (gene, cell, umi) for the gene axis, then (mapped, ref, pos, strand), so
   molecule runs, fragment runs and the (outer, pair) histogram all fall out
   of one sorted view;
3. per-group quantities are stacked segmented scans (ops.segments.RunBounds):
   0/1 count columns and the float quality moments alike. A Hillis-Steele
   segment total's combine tree depends only on positions relative to the
   segment, so a segment's f32 result is a pure function of its own records,
   wherever the entity lands in a batch: CSVs stay byte-stable across batch
   splits.

The contract is bit equality with the JAX engine on the same padded columns,
floats included: every f32 result is an IEEE elementwise op in the same
order. Nothing is compiled with ``torch.compile`` (a fused multiply-add would
change f32 bits), and nothing syncs with the host: no ``.item()``, no
``torch.nonzero``, no boolean-mask indexing. The places where the port is not
a literal translation say so where they happen.

All shapes are static: callers pad records to a bucket size with
valid=False (key columns are masked to INT32_MAX so padding sorts last).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import consts
from ..io.packed import (
    FLAG_DUPLICATE,
    FLAG_MITO,
    FLAG_NH1_SHIFT,
    FLAG_PCB_SHIFT,
    FLAG_PUMI_SHIFT,
    FLAG_RUN_START,
    FLAG_SPLICED,
    FLAG_STRAND,
    FLAG_UNMAPPED,
    FLAG_XF_SHIFT,
    KEY_CODE_BITS,
    KEY_HI_SHIFT,
    KEY_UNMAPPED_SHIFT,
    wire_layout,
)
from ..ops import segments as seg

_I32_MAX = torch.iinfo(torch.int32).max
_NAN = float("nan")


def _widen(col: torch.Tensor) -> torch.Tensor:
    """Unsigned lanes as signed integers that hold their values.

    PyTorch's uint16/uint32 have few ops, so u8/u16 lanes become int32 and
    u32 lanes int64: a u32 with its top bit set must not read negative.
    """
    if col.dtype in (torch.uint8, torch.uint16):
        return col.to(torch.int32)
    if col.dtype == torch.uint32:
        return col.to(torch.int64)
    return col


def _unpack_flags(flags: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Decode the packed int16 flag column into boolean/int fields."""
    f = flags.to(torch.int32)
    return {
        "strand": f & FLAG_STRAND,
        "unmapped": (f & FLAG_UNMAPPED) != 0,
        "duplicate": (f & FLAG_DUPLICATE) != 0,
        "spliced": (f & FLAG_SPLICED) != 0,
        "xf": (f >> FLAG_XF_SHIFT) & 7,
        "perfect_umi": ((f >> FLAG_PUMI_SHIFT) & 3) == 2,  # stored value+1
        "perfect_cb": ((f >> FLAG_PCB_SHIFT) & 3) == 2,
        "nh1": ((f >> FLAG_NH1_SHIFT) & 1) != 0,  # NH tag == 1
        "is_mito": (f & FLAG_MITO) != 0,
    }


def _unpack_frac(packed: torch.Tensor, shift: int) -> torch.Tensor:
    """above/len as float32 from an integer quality summary (0 len -> 0.0).

    ``packed`` holds non-negative values (``_widen``), so the right shift is
    the JAX version's unsigned shift.
    """
    length = (packed & ((1 << shift) - 1)).to(torch.int32)
    above = (packed >> shift).to(torch.int32)
    return torch.where(
        length > 0,
        above.to(torch.float32) / torch.clamp(length, min=1).to(torch.float32),
        0.0,
    )


def _stacked_moments(
    columns: Sequence[torch.Tensor],
    valid: torch.Tensor,
    outer_ids: torch.Tensor,
    outer_bounds: seg.RunBounds,
    count: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (means, sample variances) of stacked float columns.

    Two-pass centered moments; sample variance, nan below two observations.
    Both reductions ride the segmented scans; ``outer_ids`` only broadcasts
    the means back per record for the centering pass.
    """
    stacked = torch.stack(list(columns), dim=1)
    masked = torch.where(valid[:, None], stacked, 0.0)
    totals = outer_bounds.sum(masked)
    safe_count = torch.clamp(count, min=1).to(stacked.dtype)[:, None]
    means = torch.where(count[:, None] > 0, totals / safe_count, 0.0)
    centered = stacked - means[outer_ids.to(torch.int64)]
    sq = torch.where(valid[:, None], centered * centered, 0.0)
    m2 = outer_bounds.sum(sq)
    variances = torch.where(
        count[:, None] >= 2,
        m2 / torch.clamp(count - 1, min=1).to(stacked.dtype)[:, None],
        _NAN,
    )
    return means, variances


def _unpack_wire(
    wire: torch.Tensor,
    num_segments: int,
    wide_genomic: bool,
    small_ref: bool,
    num_runs: int = 0,
    with_cb: bool = True,
) -> Dict[str, torch.Tensor]:
    """Monoblock wire -> the prepacked named columns.

    The gatherer ships each batch as ONE int32 block
    (metrics.gatherer._pack_wire builds it from io.packed.wire_layout).
    Slices plus ``Tensor.view(dtype)`` recover every column exactly: the
    little-endian lane order matches the host's numpy views. Narrow lanes
    are widened at once (``_widen``): a u16 lane is int16 -> int32 & 0xFFFF,
    the wide u32 genomic lanes int32 -> int64 & 0xFFFFFFFF. ``flags`` stays
    int16, as in the JAX version.
    """
    n = num_segments
    cols: Dict[str, torch.Tensor] = {"n_valid": wire[:1]}
    off = 1
    for name, width in wire_layout(wide_genomic, small_ref, bool(num_runs), with_cb):
        words = n * width // 4
        chunk = wire[off : off + words]
        off += words
        if width == 4:
            if name in ("genomic_qual", "genomic_total"):
                col = chunk.to(torch.int64) & 0xFFFFFFFF
            else:
                col = chunk
        elif width == 2:
            col = chunk.view(torch.int16).reshape(n)
            if name != "flags":
                col = col.to(torch.int32) & 0xFFFF
        else:
            col = chunk.view(torch.uint8).reshape(n).to(torch.int32)
        cols[name] = col
    if num_runs:
        # run-keyed wire: per-record sort keys come back from the trailing
        # per-run table through the cumsum of the FLAG_RUN_START bits.
        # Padding records carry no start bit and clamp to the last real run,
        # masked to INT32_MAX so they still sort last
        table_hi = wire[off : off + num_runs]
        table_lo = wire[off + num_runs : off + 2 * num_runs]
        start = ((cols["flags"].to(torch.int32) & FLAG_RUN_START) != 0).to(torch.int32)
        run_id = torch.cumsum(start, 0) - 1
        valid = torch.arange(n, dtype=torch.int32, device=wire.device) < cols["n_valid"]
        run_id = torch.clamp(run_id, 0, num_runs - 1).to(torch.int64)
        cols["key_hi"] = torch.where(valid, table_hi[run_id], _I32_MAX)
        cols["key_lo"] = torch.where(valid, table_lo[run_id], _I32_MAX)
    return cols


def compute_entity_metrics(
    cols: Dict[str, torch.Tensor],
    num_segments: int,
    kind: str = "cell",
    presorted: bool = False,
    prepacked: bool = False,
    wide_genomic: bool = False,
    small_ref: bool = False,
    num_runs: int = 0,
    with_cb: bool = True,
) -> Dict[str, torch.Tensor]:
    """All metrics for one entity axis in a single pass.

    ``kind='cell'``: outer key = cell; ``kind='gene'``: outer key = gene.

    ``presorted=True`` asserts records arrive grouped by the outer entity
    key, groups in ascending code order, with padding at the end (the
    gatherer's streaming batches); with ``presorted=False`` a 3-key sort
    permutation reorders the payload first.

    ``cols`` holds int32 ``cell``/``umi``/``gene``/``ref``/``pos``, packed
    int16 ``flags``, boolean ``valid`` and the four float32 quality columns,
    all [N] with N == ``num_segments``. With ``prepacked=True`` they are the
    four packed sort operands ``key_hi``/``key_lo``/``m_ref``/``ps`` (pads
    pre-masked to INT32_MAX), a [1] int32 ``n_valid`` and the integer
    quality summaries, either as named columns or as the one ``wire`` block
    (``_unpack_wire``). Returns per-segment metric tensors plus
    ``entity_code``, ``segment_valid`` and ``n_entities``.
    """
    if kind not in ("cell", "gene"):
        raise ValueError(f"kind must be 'cell' or 'gene', got {kind!r}")
    if prepacked and not presorted:
        raise ValueError("prepacked batches must also be presorted")

    if prepacked and tuple(cols) == ("wire",):
        cols = _unpack_wire(
            cols["wire"], num_segments, wide_genomic, small_ref, num_runs,
            with_cb=with_cb,
        )
    else:
        cols = {name: _widen(value) for name, value in cols.items()}
    device = cols["flags"].device
    iota = torch.arange(num_segments, dtype=torch.int32, device=device)

    if prepacked:
        # the host shipped the four packed sort operands plus a [1] valid
        # count, compared against the iota without leaving the device
        valid = iota < cols["n_valid"]
        k1 = torch.where(valid, cols["key_hi"] >> KEY_HI_SHIFT, _I32_MAX)
        if small_ref:
            m8 = cols["m_ref"].to(torch.int32)
            m_ref = torch.where(
                valid, ((m8 >> 7) << KEY_UNMAPPED_SHIFT) | (m8 & 0x7F), _I32_MAX
            )
        else:
            m_ref = cols["m_ref"]
    else:
        valid = cols["valid"].to(torch.bool)
        bits_pre = _unpack_flags(cols["flags"])
        if kind == "cell":
            # the pair slot carries gene<<1|mito: one sorted view then
            # yields the (cell, gene) histogram with its mito split
            key_cols = (
                cols["cell"],
                (cols["gene"].to(torch.int32) << 1) | bits_pre["is_mito"].to(torch.int32),
                cols["umi"],
            )
        else:
            key_cols = (cols["gene"], cols["cell"], cols["umi"])
        keys = [torch.where(valid, c.to(torch.int32), _I32_MAX) for c in key_cols]
        if not presorted:
            # a stable sort: JAX's unstable lax.sort may order ties otherwise
            perm = seg.sort_permutation(keys)
            cols = {name: value[perm] for name, value in cols.items()}
            valid = cols["valid"].to(torch.bool)
            keys = [k[perm] for k in keys]
        k1 = keys[0]

    bits = _unpack_flags(cols["flags"])
    mapped = valid & ~bits["unmapped"]

    # ---- the ONE key-only sort: (outer, pair, inner, mapped, ref, pos,
    # strand). The JAX version is one multi-operand lax.sort; here stable
    # torch.sort passes over int64 keys packed from int32 pairs
    # (seg.lexsort). Every operand is a key, so the sorted tuples are the same.
    if prepacked:
        sorted_keys, _ = seg.lexsort([cols["key_hi"], cols["key_lo"], m_ref, cols["ps"]], [])
        s_hi, s_lo, s_mref = sorted_keys[0], sorted_keys[1], sorted_keys[2]
        s_valid = s_hi != _I32_MAX
        s_mapped = s_valid & ((s_mref >> KEY_UNMAPPED_SHIFT) == 0)
        outer_sorted_keys = [s_hi >> KEY_HI_SHIFT]
        pair_keys = [s_hi, s_lo >> KEY_CODE_BITS]
        triple_keys = [s_hi, s_lo]
        s_pair_low_bit = (s_lo >> KEY_CODE_BITS) & 1
    else:
        sorted_keys, _ = seg.lexsort(
            keys
            + [
                torch.where(mapped, 0, 1).to(torch.int32),
                torch.where(valid, cols["ref"].to(torch.int32), _I32_MAX),
                torch.where(valid, cols["pos"].to(torch.int32), _I32_MAX),
                torch.where(valid, bits["strand"], _I32_MAX),
            ],
            [],
        )
        s_valid = sorted_keys[0] != _I32_MAX
        s_mapped = s_valid & (sorted_keys[3] == 0)
        outer_sorted_keys = sorted_keys[:1]
        pair_keys = sorted_keys[:2]
        triple_keys = sorted_keys[:3]
        s_pair_low_bit = sorted_keys[1] & 1

    outer_starts = seg.run_starts([k1])  # record order
    outer_bounds = seg.RunBounds(outer_starts)
    s_outer_starts = seg.run_starts(outer_sorted_keys)
    s_outer_bounds = seg.RunBounds(s_outer_starts)

    triple_starts = seg.run_starts(triple_keys)
    pair_starts = seg.run_starts(pair_keys)
    frag_starts = seg.run_starts(sorted_keys)

    # ---- record-order counters: one stacked segmented scan ---------------
    xf = bits["xf"]
    int_cols = [
        valid,                                      # n_reads
        valid & bits["perfect_umi"],                # perfect_molecule_barcodes
        mapped & (xf == consts.XF_CODING),          # reads_mapped_exonic
        mapped & (xf == consts.XF_INTRONIC),        # reads_mapped_intronic
        mapped & (xf == consts.XF_UTR),             # reads_mapped_utr
        mapped & bits["nh1"],                       # reads_mapped_uniquely
        mapped & ~bits["nh1"],                      # reads_mapped_multiple
        mapped & bits["duplicate"],                 # duplicate_reads
        mapped & bits["spliced"],                   # spliced_reads
    ]
    if kind == "cell":
        # XF checks in the cell extras ignore mapped state: INTERGENIC counts
        # any read carrying that value; a missing XF counts toward
        # reads_unmapped
        int_cols += [
            valid & bits["perfect_cb"],             # perfect_cell_barcodes
            valid & (xf == consts.XF_INTERGENIC),   # reads_mapped_intergenic
            valid & (xf == consts.XF_MISSING),      # reads_unmapped
        ]
    record_sums = outer_bounds.sum(torch.stack(int_cols, dim=1).to(torch.int32))
    (
        n_reads,
        perfect_molecule_barcodes,
        reads_mapped_exonic,
        reads_mapped_intronic,
        reads_mapped_utr,
        reads_mapped_uniquely,
        reads_mapped_multiple,
        duplicate_reads,
        spliced_reads,
    ) = (record_sums[:, i] for i in range(9))

    # ---- sorted-side histograms: one stacked segmented scan --------------
    s_cols = [
        triple_starts & s_valid,                        # n_molecules
        seg.run_is_singleton(triple_starts) & s_valid,  # molecules single
        frag_starts & s_mapped,                         # n_fragments
        seg.run_is_singleton(frag_starts) & s_mapped,   # fragments single
        pair_starts & s_valid,                          # pair histogram size
        seg.run_is_plural(pair_starts) & s_valid,       # pairs seen > once
    ]
    if kind == "cell":
        s_mito = s_valid & (s_pair_low_bit == 1)
        s_cols += [
            pair_starts & s_mito,                       # n_mitochondrial_genes
            s_mito,                                     # mito reads
        ]
    sorted_sums = s_outer_bounds.sum(torch.stack(s_cols, dim=1).to(torch.int32))
    n_molecules = sorted_sums[:, 0]
    molecules_single = sorted_sums[:, 1]
    n_fragments = sorted_sums[:, 2]
    frag_single = sorted_sums[:, 3]

    # ---- float quality moments: same stacked segmented scans -------------
    if prepacked:
        gshift = 16 if wide_genomic else 8
        glen = (cols["genomic_qual"] & ((1 << gshift) - 1)).to(torch.int32)
        quality_cols = [
            _unpack_frac(cols["umi_qual"], 8),
            _unpack_frac(cols["genomic_qual"], gshift),
            torch.where(
                glen > 0,
                cols["genomic_total"].to(torch.float32)
                / torch.clamp(glen, min=1).to(torch.float32),
                0.0,
            ),
        ]
        if kind == "cell":
            quality_cols.append(_unpack_frac(cols["cb_qual"], 8))
    else:
        quality_cols = [cols["umi_frac30"], cols["genomic_frac30"], cols["genomic_mean"]]
        if kind == "cell":
            quality_cols.append(cols["cb_frac30"])
    outer_ids = seg.segment_ids_from_starts(outer_starts)
    means, variances = _stacked_moments(
        quality_cols, valid, outer_ids, outer_bounds, n_reads
    )

    zeros = torch.zeros_like(n_reads)
    f_reads = n_reads.to(torch.float32)
    f_molecules = n_molecules.to(torch.float32)
    f_fragments = n_fragments.to(torch.float32)

    out = {
        "n_reads": n_reads,
        "noise_reads": zeros,  # NotImplemented in the reference; always 0
        "perfect_molecule_barcodes": perfect_molecule_barcodes,
        "reads_mapped_exonic": reads_mapped_exonic,
        "reads_mapped_intronic": reads_mapped_intronic,
        "reads_mapped_utr": reads_mapped_utr,
        "reads_mapped_uniquely": reads_mapped_uniquely,
        "reads_mapped_multiple": reads_mapped_multiple,
        "duplicate_reads": duplicate_reads,
        "spliced_reads": spliced_reads,
        "antisense_reads": zeros,  # never incremented in the reference
        "molecule_barcode_fraction_bases_above_30_mean": means[:, 0],
        "molecule_barcode_fraction_bases_above_30_variance": variances[:, 0],
        "genomic_reads_fraction_bases_quality_above_30_mean": means[:, 1],
        "genomic_reads_fraction_bases_quality_above_30_variance": variances[:, 1],
        "genomic_read_quality_mean": means[:, 2],
        "genomic_read_quality_variance": variances[:, 2],
        "n_molecules": n_molecules,
        "n_fragments": n_fragments,
        "reads_per_molecule": torch.where(
            n_molecules > 0, f_reads / torch.clamp(f_molecules, min=1), _NAN
        ),
        "reads_per_fragment": torch.where(
            n_fragments > 0, f_reads / torch.clamp(f_fragments, min=1), _NAN
        ),
        "fragments_per_molecule": torch.where(
            n_molecules > 0, f_fragments / torch.clamp(f_molecules, min=1), _NAN
        ),
        "fragments_with_single_read_evidence": frag_single,
        "molecules_with_single_read_evidence": molecules_single,
    }

    if kind == "cell":
        n_mito_molecules = sorted_sums[:, 7]
        out.update(
            {
                "perfect_cell_barcodes": record_sums[:, 9],
                "reads_mapped_intergenic": record_sums[:, 10],
                "reads_unmapped": record_sums[:, 11],
                "reads_mapped_too_many_loci": zeros,
                "cell_barcode_fraction_bases_above_30_variance": variances[:, 3],
                "cell_barcode_fraction_bases_above_30_mean": means[:, 3],
                "n_genes": sorted_sums[:, 4],
                "genes_detected_multiple_observations": sorted_sums[:, 5],
                "n_mitochondrial_genes": sorted_sums[:, 6],
                "n_mitochondrial_molecules": n_mito_molecules,
                # read-weighted percentage (reference aggregator.py:463-490)
                "pct_mitochondrial_molecules": torch.where(
                    n_mito_molecules > 0,
                    n_mito_molecules.to(torch.float32)
                    / torch.clamp(n_reads, min=1).to(torch.float32)
                    * 100.0,
                    0.0,
                ),
            }
        )
    else:
        out.update(
            {
                "number_cells_detected_multiple": sorted_sums[:, 5],
                "number_cells_expressing": sorted_sums[:, 4],
            }
        )

    n_entities = torch.sum(
        torch.where(valid, outer_starts, False).to(torch.int32), dtype=torch.int32
    )
    out["entity_code"] = outer_bounds.first(k1, _I32_MAX)
    out["segment_valid"] = iota < n_entities
    out["n_entities"] = n_entities
    return out


def compact_results(
    result: Dict[str, torch.Tensor],
    int_names: Tuple[str, ...],
    float_names: Tuple[str, ...],
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack the first k rows of each metric column into two dense tensors
    ([k, n_int] int32 and [k, n_float] float32). ``k`` is a bucketed bound
    >= n_entities."""
    ints = torch.stack([result[name][:k].to(torch.int32) for name in int_names], dim=1)
    floats = torch.stack([result[name][:k].to(torch.float32) for name in float_names], dim=1)
    return ints, floats


def compact_results_wire(
    result: Dict[str, torch.Tensor],
    int_names: Tuple[str, ...],
    float_names: Tuple[str, ...],
    k: int,
) -> torch.Tensor:
    """compact_results fused into ONE [n_int + n_float, k] int32 block.

    The float half travels as its exact float32 bit pattern
    (``Tensor.view(torch.int32)``). Column-major, so on the host the float
    half is a contiguous row block and ``block[n_int:].view(np.float32)`` is
    a zero-copy view. The columns are stacked along the leading axis
    directly rather than stacked and transposed; the block is the same.
    """
    ints = torch.stack([result[name][:k].to(torch.int32) for name in int_names])
    floats = torch.stack([result[name][:k].to(torch.float32) for name in float_names])
    return torch.cat([ints, floats.view(torch.int32)])
