"""Each traffic kind driven end to end on the CPU at a small size: correct
on the program as it is, not correct with the timed path broken underneath
(each fault a cell can have), and not correct for the control.

The measurement path itself refuses a machine without a card; these tests
call ``core.measure`` past that look, with the CPU as the device."""

import time

import numpy as np
import pytest
import torch

from gpubench import core
from gpubench.tests.small import small_cell

SEED = 3_000_000_017


def measure(cell):
    return core.measure(cell, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())


@pytest.fixture()
def lane(tmp_path):
    return small_cell("fastq-10xv3", tmp_path)


@pytest.fixture()
def chunk(tmp_path):
    return small_cell("cellmetrics-10xv2", tmp_path)


def test_lane_is_correct(lane):
    result = measure(lane)
    assert result["correct"], result["compared"]
    assert result["attempted"] == 8192 * (result["attempted"] // 8192) and result["failed"] == 0
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(result)[-1] == "compared"


def test_lane_with_calls_no_sequencer_makes_is_correct(tmp_path):
    """The edge cases left out of the card's traffic: an N in a barcode, a
    lowercase barcode, IUPAC and lowercase bases in R2."""
    cell = small_cell("fastq-10xv3", tmp_path)
    cell.traffic = dict(cell.traffic, edge_cases={"n_call": 0.03, "lowercase_barcode": 0.02, "r2_odd_bases": 0.01})
    result = measure(cell)
    assert result["correct"], result["compared"]


def test_lane_barcodes_follow_the_traffic_figures():
    """The shares of exact, miscalled and invalid barcodes that the traffic
    file's figures give, measured against each read's source barcode."""
    import json

    from gpubench.gen import fastq as gen

    traffic = json.loads((core.BENCH / "traffic" / "fastq_lane.json").read_text())
    rng = np.random.default_rng(SEED)
    whitelist = gen.make_whitelist(rng, 50000, 16)
    n = 200000
    source = gen.lane_sources(rng, len(whitelist), n, 1000, traffic["fraction_reads_in_cells"], traffic["cell_sigma"])
    distance = (gen.lane_barcodes(rng, whitelist, source, traffic) != whitelist[source]).sum(axis=1)
    valid, error = traffic["valid_barcodes"], traffic["barcode_base_error"]
    assert abs((distance == 0).mean() - valid * (1 - error) ** 16) < 0.005
    assert abs((distance == 1).mean() - valid * 16 * error * (1 - error) ** 15) < 0.002
    assert abs((distance == 2).mean() - (1 - valid)) < 0.005
    rows, counts = np.unique(source, return_counts=True)
    in_cells = np.isin(source, rows[counts > 20])  # the 1,000 cells; ambient rows hold a few reads each
    assert abs(in_cells.mean() - traffic["fraction_reads_in_cells"]) < 0.01


def _wrap_indices(monkeypatch, change):
    from sctools_tpu_torch.ops.whitelist import WhitelistCorrector

    original = WhitelistCorrector.submit_block

    def submit_block(self, block, lengths):
        pending = original(self, block, lengths)

        class Changed:
            def indices(self_inner):
                return change(pending.indices().copy())

        return Changed()

    monkeypatch.setattr(WhitelistCorrector, "submit_block", submit_block)


def test_lane_state_unchanged(lane, monkeypatch):
    from sctools_tpu_torch.fastqprocess import FastqProcess

    result_ok = measure(lane)
    assert result_ok["correct"]
    monkeypatch.setattr(FastqProcess, "run", lambda self: dict(self.stats))
    result = measure(lane)
    assert not result["correct"] and result["compared"]["reads_wrong"]["value"] > 0


def test_lane_half_the_batch_left_out(lane, monkeypatch):
    def half(indices):
        indices[len(indices) // 2:] = -1
        return indices

    _wrap_indices(monkeypatch, half)
    result = measure(lane)
    assert not result["correct"] and result["compared"]["reads_wrong"]["value"] > 0


def test_lane_one_answer_altered(lane, monkeypatch):
    def alter(indices):
        hit = np.flatnonzero(indices >= 0)
        indices[hit[0]] = (indices[hit[0]] + 1) % 20000
        return indices

    _wrap_indices(monkeypatch, alter)
    result = measure(lane)
    assert not result["correct"]
    assert result["compared"]["reads_wrong"]["value"] >= 1


def test_lane_control_is_not_correct(tmp_path):
    """The control breaks the tie rule; a dense whitelist (20,000 of 4^10
    barcodes) has ties enough to show it at this size."""
    cell = small_cell("fastq-10xv3", tmp_path, barcode_length=10, cb_span=[0, 10], umi_span=[10, 22])
    kind = cell.kind
    work = tmp_path / "work"
    work.mkdir()
    state = kind.setup(core.Context(cell.name, cell.config, cell.traffic, SEED, work, torch.device("cpu"), False))
    assert kind.run_pass(state, 0) == 8192
    program = kind.check(state, [{}])
    assert all(value <= limit for value, limit in program.values()), program
    control = kind.control(state)
    assert any(value > limit for value, limit in control.values()), control


def test_chunk_is_correct(chunk):
    result = measure(chunk)
    assert result["correct"], result["compared"]
    assert set(result["metrics"]) == {"records_per_s", "setup_s"}


def test_chunk_state_unchanged(chunk, monkeypatch):
    from sctools_tpu_torch.metrics.gatherer import GatherCellMetrics

    monkeypatch.setattr(GatherCellMetrics, "extract_metrics", lambda self, mode="rb": None)
    result = measure(chunk)
    assert not result["correct"] and result["compared"]["cells_wrong"]["value"] > 0


def _wrap_block(monkeypatch, change):
    from sctools_tpu_torch.metrics.writer import MetricCSVWriter

    original = MetricCSVWriter.write_block

    def write_block(self, index, columns):
        index, columns = change(list(index), [np.array(c, copy=True) for c in columns])
        return original(self, index, columns)

    monkeypatch.setattr(MetricCSVWriter, "write_block", write_block)


def test_chunk_half_the_batch_left_out(chunk, monkeypatch):
    _wrap_block(monkeypatch, lambda index, columns: (index[: len(index) // 2],
                                                     [c[: len(index) // 2] for c in columns]))
    result = measure(chunk)
    assert not result["correct"] and result["compared"]["cells_wrong"]["value"] > 0


def test_chunk_one_answer_altered(chunk, monkeypatch):
    def alter(index, columns):
        columns[0][0] += 1  # n_reads of the first cell
        return index, columns

    _wrap_block(monkeypatch, alter)
    result = measure(chunk)
    assert not result["correct"] and result["compared"]["counts_wrong"]["value"] >= 1


def test_chunk_one_float_altered(chunk, monkeypatch):
    def alter(index, columns):
        columns[11][0] *= 1.05  # a quality mean of the first cell
        return index, columns

    _wrap_block(monkeypatch, alter)
    result = measure(chunk)
    assert not result["correct"] and result["compared"]["float_gap"]["value"] > 0.04


def test_chunk_control_is_not_correct(chunk, tmp_path):
    kind = chunk.kind
    work = tmp_path / "work"
    work.mkdir()
    state = kind.setup(core.Context(chunk.name, chunk.config, chunk.traffic, SEED, work, torch.device("cpu"), False))
    kind.run_pass(state, 0)
    program = kind.check(state, [{}])
    assert all(value <= limit for value, limit in program.values()), program
    control = kind.control(state)
    assert any(value > limit for value, limit in control.values()), control
