"""UMI-deduplicated molecule counting as sorted-segment ops.

The port of ``sctools_tpu.ops.counting`` (ops/counting.py:38-118), on the
port's ``ops/segments.py``. Query-name groups become runs of a sort, the
CellRanger eligibility rule becomes a per-group distinct-run count, and the
(cell, umi, gene) dedup set becomes run detection on a second sort. A query
is counted iff exactly ONE distinct eligible gene is implicated across its
alignments, which reproduces both of the reference's branches (a lone
ineligible alignment implicates 0 genes, a lone eligible one 1, and a
multi-mapped query needs a unique gene).

Eligibility per alignment is precomputed on the host (``count.py``
``device_count_columns``): GE present, XF present and not INTERGENIC, and
not a multi-gene "a,b" name.

Plain PyTorch ops on the device of the inputs, one function for CPU and
CUDA tensors alike; nothing here syncs with the host (no ``.item()``, no
``torch.nonzero``, no boolean-mask indexing). The port's sort is stable
where ``jax.lax.sort`` is not; every output is the same either way, because
rows that tie on (qname, gene) are reduced only by order-free sums and
minima, and rows that tie on (cell, gene, umi) share their keys, their
``keep`` flag and their run minimum.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import segments as seg

_I32_MAX = torch.iinfo(torch.int32).max


def count_molecules(cols: Dict[str, torch.Tensor], num_segments: int) -> Dict[str, torch.Tensor]:
    """Unique (cell, molecule, gene) triples from query-name groups.

    ``cols``: 1-D tensors of length ``num_segments``: ``qname``, ``cell``,
    ``umi``, ``gene`` codes, and the flags ``eligible`` (per-alignment
    eligibility), ``cb_ok`` / ``ub_ok`` (barcode tag present) and
    ``valid`` (a real record, not padding). Records of one query need not be
    adjacent: the sort groups them.

    Returns ``[num_segments]`` tensors in the dedup sort's order:
      - ``is_molecule`` (bool): one True per unique counted triple;
      - ``cell``, ``umi``, ``gene`` (int32): the codes of the triple
        (``I32_MAX`` on rows that count nothing);
      - ``first_index`` (int32): the smallest record index of any query
        group that yields the triple (the reference's first-observation
        cell order, count.py:319-329).
    """
    valid = cols["valid"].to(torch.bool)
    eligible = valid & cols["eligible"].to(torch.bool)
    idx = torch.arange(num_segments, dtype=torch.int32, device=valid.device)

    qname_key = torch.where(valid, cols["qname"].to(torch.int32), _I32_MAX)
    gene_key = torch.where(eligible, cols["gene"].to(torch.int32), _I32_MAX)

    # group alignments by query, eligible genes ascending within each group
    (s_qname, s_gene), (s_idx, s_eligible, s_valid) = seg.lexsort(
        [qname_key, gene_key], [idx, eligible, valid]
    )
    group_bounds = seg.RunBounds(seg.run_starts([s_qname]))
    pair_starts = seg.run_starts([s_qname, s_gene])

    # per group slot: distinct eligible genes, the smallest one (the group's
    # first row, gene being the second sort key), and the first record
    distinct_genes = group_bounds.sum((pair_starts & s_eligible).to(torch.int32))
    chosen_gene = group_bounds.first(s_gene, _I32_MAX)
    first_idx = group_bounds.min(torch.where(s_valid, s_idx, _I32_MAX), _I32_MAX)

    # tags come from the group's first alignment in FILE order
    # (count.py:86-95 reads alignments[0])
    safe_first = torch.clamp(first_idx, 0, num_segments - 1).to(torch.int64)
    group_cell = cols["cell"].to(torch.int32)[safe_first]
    group_umi = cols["umi"].to(torch.int32)[safe_first]
    group_cb_ok = cols["cb_ok"].to(torch.bool)[safe_first]
    group_ub_ok = cols["ub_ok"].to(torch.bool)[safe_first]
    group_valid = first_idx < _I32_MAX

    keep = group_valid & (distinct_genes == 1) & group_cb_ok & group_ub_ok

    # dedup triples: one count per unique (cell, gene, umi)
    mcell = torch.where(keep, group_cell, _I32_MAX)
    mgene = torch.where(keep, chosen_gene, _I32_MAX)
    mumi = torch.where(keep, group_umi, _I32_MAX)
    d_keys, (d_first, d_keep) = seg.lexsort([mcell, mgene, mumi], [first_idx, keep])
    d_cell, d_gene, d_umi = d_keys
    triple_starts = seg.run_starts(d_keys)
    triple_ids = seg.segment_ids_from_starts(triple_starts).to(torch.int64)
    triple_first = seg.RunBounds(triple_starts).min(
        torch.where(d_keep, d_first, _I32_MAX), _I32_MAX
    )
    return {
        "is_molecule": triple_starts & d_keep,
        "cell": d_cell,
        "umi": d_umi,
        "gene": d_gene,
        "first_index": triple_first[triple_ids],
    }
