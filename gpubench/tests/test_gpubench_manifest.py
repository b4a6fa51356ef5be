"""BENCHMARK.json against the benchmark's contract, and cells resolved from
files alone."""

import json
import re

import pytest

from gpubench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per",
               "barcode_length", "umi_length", "r1_length", "r2_length", "i1_length", "read_length")


@pytest.fixture(scope="module")
def manifest():
    return core.load_manifest()


def one_line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(manifest):
    assert set(manifest) == KEYS["top"]
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32 and all(one_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for path in manifest["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    names = []
    for config in manifest["configs"]:
        assert set(config) == KEYS["config"]
        assert NAME.match(config["name"]) and one_line(config["source"]) and one_line(config["why"])
        assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
        names.append(config["name"])
    for cell in manifest["workloads"]:
        assert set(cell) == KEYS["workload"]
        assert NAME.match(cell["name"]) and NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4) and one_line(cell["why"])
        names.append(cell["name"])
    for kind in ("end_to_end", "per_layer"):
        for metric in manifest[kind]:
            assert set(metric) - {"workloads"} == KEYS[kind], metric
            assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
            assert metric["better"] in ("lower", "higher")
            names.append(metric["name"])
    assert len(names) == len(set(names))


def test_sources_bounds_and_moves(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for metric in e2e.values():
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    layers = {}
    for metric in manifest["per_layer"]:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in e2e and one_line(metric["layer"])
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
        for cell in metric["workloads"]:
            # a cell that reports a per-layer metric reports the metric it moves
            assert "workloads" not in e2e[metric["moves"]] or cell in e2e[metric["moves"]]["workloads"]
        layers.setdefault(metric["layer"], []).append(metric["name"])
    for cell in manifest["workloads"]:
        reported = [m for m in manifest["end_to_end"] if "workloads" not in m or cell["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell["name"] in m["workloads"] for m in manifest["per_layer"])


def test_budget_fits_24_cells(manifest):
    seconds = manifest["run_seconds"]
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(c["chips"] == 4 for c in manifest["workloads"]) <= max(1, len(manifest["workloads"]) // 4)


def test_config_files_hold_their_cuts(manifest):
    for config in manifest["configs"]:
        path = core.ROOT / config["file"]
        assert config["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        values = json.loads(path.read_text())
        assert values["name"] == config["name"]
        assert set(config["reduced"]) == set(values["reduced"])
        for key in config["reduced"]:
            assert key in values and values["reduced"][key]["here"] == values[key]
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))


def test_every_cell_resolves(manifest):
    for entry in manifest["workloads"]:
        cell = core.resolve(json.loads(json.dumps(manifest)), entry["name"])
        assert cell.per_layer and all(hasattr(m["reader"], "read") for m in cell.per_layer)
        for name in ("build", "setup", "run_pass", "check", "control", "end_to_end", "program_seconds",
                     "pass_counts", "span_targets"):
            assert callable(getattr(cell.kind, name))


def test_a_new_cell_is_data_alone(manifest):
    """fastq-10xv2, the next cell: an entry that points the lane at the v2
    configuration resolves with no file but the manifest changed."""
    grown = json.loads(json.dumps(manifest))
    grown["workloads"].append({"name": "fastq-10xv2", "config": "optimus-10xv2", "traffic": "fastq_lane",
                               "chips": 1, "why": "the v2 whitelist: the control for kernel changes"})
    for metric in grown["end_to_end"] + grown["per_layer"]:
        if "fastq-10xv3" in metric.get("workloads", []):
            metric["workloads"].append("fastq-10xv2")
    cell = core.resolve(grown, "fastq-10xv2")
    assert cell.config["whitelist_size"] == 737280 and cell.config["r2_length"] == 98
    assert cell.traffic["kind"] == "fastq_lane"
    assert {m["name"] for m in cell.per_layer} >= {"fastq.read", "whitelist_correct_roofline"}


def test_a_missing_file_refuses(manifest):
    broken = json.loads(json.dumps(manifest))
    broken["workloads"][0]["traffic"] = "no_such_mix"
    with pytest.raises(core.Refused):
        core.resolve(broken, broken["workloads"][0]["name"])
    with pytest.raises(core.Refused):
        core.resolve(manifest, "no-such-cell")
