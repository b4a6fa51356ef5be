"""Cells cut to a size the CPU tests can hold: the manifest's cells with
their configurations' sizes cut, written to a temporary directory."""

from __future__ import annotations

import json
from pathlib import Path

from gpubench import core

# a chunk of 10 cells of ~2,100 records and 400 background barcodes of ~22
SMALL = dict(whitelist_size=20000, lane_reads=8192, chunk_records=30000, cells=500, read_pairs_per_cell=4000,
             genes=500, n_shards=4)


def small_cell(name: str, tmp: Path, manifest: dict = None, **sizes) -> core.Cell:
    manifest = json.loads(json.dumps(manifest or core.load_manifest()))
    for config in manifest["configs"]:
        values = json.loads((core.ROOT / config["file"]).read_text())
        values.update(SMALL, **sizes)
        path = tmp / Path(config["file"]).name
        path.write_text(json.dumps(values))
        config["file"] = str(path)
    return core.resolve(manifest, name)
