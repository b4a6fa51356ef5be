"""The port's GroupQCs (``sctools_tpu_torch.groups``) against the JAX package.

The JAX writers go through pandas (``from_dict`` / ``insert`` / ``.T`` /
``to_csv``, ``read_csv`` / ``concat(axis=1, join="outer")``); the port writes
the same bytes without it. Every case runs both through ``group_qc_outputs``
on the same files and compares the CSVs byte for byte: the inputs of
``tests/test_groups.py`` for all five types, then one case per pandas rule
the port reproduces, each also pinned to the bytes pandas gives.
"""

from __future__ import annotations

import textwrap

import pytest

from sctools_tpu import platform as jax_platform
from sctools_tpu_torch import platform as port_platform

from test_groups import (
    _write_hisat2_log,
    _write_picard_alignment,
    _write_picard_duplication,
    _write_rsem_cnt,
)


def _both(tmp_path, metrics_type, files, outputs=("",)):
    """Run both ``group_qc_outputs`` on ``files``; returns the port's bytes
    of each output suffix after asserting they equal JAX's."""
    got = []
    for side, entry in (("jax", jax_platform), ("port", port_platform)):
        prefix = str(tmp_path / side)
        assert entry.GenericPlatform.group_qc_outputs(
            ["-f", *files, "-o", prefix, "-t", metrics_type]) == 0
        got.append([open(f"{prefix}{suffix}.csv", "rb").read() for suffix in outputs])
    assert got[1] == got[0]
    return got[1]


def _picard(path, class_name, header, *rows):
    lines = ["## htsjdk.samtools.metrics.StringHeader", "# Tool INPUT=x.bam",
             f"## METRICS CLASS\t{class_name}", "\t".join(header)]
    lines += ["\t".join(row) for row in rows]
    path.write_text("\n".join(lines) + "\n\n## HISTOGRAM\tjava.lang.Integer\nx\ty\n1\t2\n")
    return str(path)


def test_picard_by_row_matches_jax(tmp_path):
    files = [
        _write_picard_alignment(tmp_path / "cellA_qc.alignment_summary_metrics.txt"),
        _write_picard_duplication(tmp_path / "cellA_qc.duplication_metrics.txt"),
        _write_picard_alignment(tmp_path / "cellB_qc.alignment_summary_metrics.txt", total=500),
    ]
    (out,) = _both(tmp_path, "Picard", files)
    assert out.startswith(b",TOTAL_READS.FIRST_OF_PAIR,")


def test_picard_by_table_matches_jax(tmp_path):
    files = [_write_picard_duplication(tmp_path / "cellA_qc.duplication_metrics.txt")]
    (out,) = _both(tmp_path, "PicardTable", files, outputs=("_duplication_metrics",))
    assert out == b"Sample,LIBRARY,READ_PAIRS_EXAMINED,PERCENT_DUPLICATION\ncellA,lib1,400,0.25\n"


def test_hisat2_matches_jax(tmp_path):
    files = [
        _write_hisat2_log(tmp_path / "cellA_qc.log"),
        _write_hisat2_log(tmp_path / "cellB_rsem.log"),
    ]
    (out,) = _both(tmp_path, "HISAT2", files)
    assert out.splitlines()[1] == b"Class,HISAT2T,HISAT2T,HISAT2T,HISAT2T,HISAT2T"


def test_rsem_matches_jax(tmp_path):
    files = [_write_rsem_cnt(tmp_path / "cellA_rsem.cnt"), _write_rsem_cnt(tmp_path / "cellB_rsem.cnt")]
    (out,) = _both(tmp_path, "RSEM", files)
    assert out.splitlines()[2].startswith(b"cellA,100,850,50,1000,700,150,1200,0,25")


def test_core_outer_join_matches_jax(tmp_path):
    """tests/test_groups.py's join of a Picard and a HISAT2 aggregate."""
    picard = str(tmp_path / "picard")
    hisat = str(tmp_path / "hisat2")
    jax_platform.GenericPlatform.group_qc_outputs(
        ["-f", _write_picard_alignment(tmp_path / "cellA_qc.alignment_summary_metrics.txt"),
         "-o", picard, "-t", "Picard"])
    jax_platform.GenericPlatform.group_qc_outputs(
        ["-f", _write_hisat2_log(tmp_path / "cellA_qc.log"), "-o", hisat, "-t", "HISAT2"])
    (out,) = _both(tmp_path, "Core", [picard + ".csv", hisat + ".csv"])
    assert b"Total reads" in out.splitlines()[0]


# -------------------------------------------------- one case per pandas rule


def test_all_numeric_cell_prints_ints_as_floats(tmp_path):
    """A cell whose values are all numbers or missing is a float64 column:
    after ``.T`` its ints print as ``1.0``; a cell with any string keeps its
    ints as ``3``; a cell of ints only stays int64."""
    header = ["CATEGORY", "TOTAL_READS", "PF_READS", "MEAN", "NOTE"]
    files = [
        _picard(tmp_path / "floaty_qc.alignment_summary_metrics.txt",
                "picard.analysis.AlignmentSummaryMetrics", header, ["PAIR", "7", "6", "0.5", ""]),
        _picard(tmp_path / "texty_qc.alignment_summary_metrics.txt",
                "picard.analysis.AlignmentSummaryMetrics", header, ["PAIR", "3", "2", "1.5", "ok"]),
        _picard(tmp_path / "inty_qc.duplication_metrics.txt",
                "picard.sam.DuplicationMetrics", ["LIBRARY", "READ_PAIRS_EXAMINED"], ["lib", "400"]),
    ]
    (out,) = _both(tmp_path, "Picard", files)
    assert out.decode().splitlines() == [
        ",TOTAL_READS.PAIR,PF_READS.PAIR,MEAN.PAIR,NOTE.PAIR,READ_PAIRS_EXAMINED",
        "Class,AlignmentSummaryMetrics,AlignmentSummaryMetrics,AlignmentSummaryMetrics,"
        "AlignmentSummaryMetrics,DuplicationMetrics",
        "floaty,7.0,6.0,0.5,,",
        "texty,3,2,1.5,ok,",
        "inty,,,,,400.0",
    ]


def test_missing_metric_prints_empty(tmp_path):
    """A missing metric is an empty field; a table column of ints with a
    missing value prints its ints as ``400.0``; ``?`` reads as missing."""
    header = ["LIBRARY", "READ_PAIRS_EXAMINED", "PERCENT_DUPLICATION", "NAME"]
    files = [_picard(tmp_path / "cellA_qc.duplication_metrics.txt", "picard.sam.DuplicationMetrics",
                     header, ["lib1", "400", "?", "a,b"], ["lib2", "", "0.25", 'say "x"'])]
    (out,) = _both(tmp_path, "PicardTable", files, outputs=("_duplication_metrics",))
    assert out.decode() == (
        "Sample,LIBRARY,READ_PAIRS_EXAMINED,PERCENT_DUPLICATION,NAME\n"
        'cellA,lib1,400.0,,"a,b"\n'
        'cellA,lib2,,0.25,"say ""x"""\n'
    )


def test_core_later_file_adds_rows(tmp_path):
    """The outer join keeps first-seen order: a later file's new rows come
    after the earlier ones, and an int column that gains a missing row
    prints as ``2.0``. Columns read as pandas types them: ``007`` is 7,
    ``TRUE`` is True, repeated names get ``.1``, and an index header that
    the files disagree on is dropped."""
    first = tmp_path / "first.csv"
    first.write_text("cell,n,flag,x,x\nB,2,TRUE,0.10,a\nA,007,false,1e5,b\n")
    second = tmp_path / "second.csv"
    second.write_text("cell,n,ratio\nC,5,NA\nA,3,2.5\n")
    third = tmp_path / "third.csv"
    third.write_text(",m\nB,1\nA,2\nC,3\n")
    (out,) = _both(tmp_path, "Core", [str(first), str(second), str(third)])
    assert out.decode() == textwrap.dedent("""\
        ,n,flag,x,x.1,n,ratio,m
        B,2.0,True,0.1,a,,,1
        A,7.0,False,100000.0,b,3.0,2.5,2
        C,,,,,5.0,,3
        """)


@pytest.mark.parametrize("texts", [
    ("c,x\nA,1\nB,2\n", "c,y\nB,3\nA,4\n"),
    ("c,x\n1,1\n3,2\n", "c,y\n2,3\n"),
    ("c,x\n1,1\n", "c,y\n2.5,3\n"),
], ids=["same-rows-reordered", "int-index", "int-and-float-index"])
def test_core_index_cases_match_jax(tmp_path, texts):
    files = []
    for i, text in enumerate(texts):
        path = tmp_path / f"in{i}.csv"
        path.write_text(text)
        files.append(str(path))
    _both(tmp_path, "Core", files)
