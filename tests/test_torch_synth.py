"""The port's synthetic generators against the JAX package's, on the CPU.

``sctools_tpu_torch.native.synth_bam_native`` (``native/synth.cpp``, built
into the port's native library at first use) writes the JAX generator's
records for the same arguments and seed: the BAMs are compared
decompressed, since the port's BGZF writer is zlib's and JAX's libdeflate.
``sctools_tpu_torch.utils.make_synthetic_columns`` gives JAX's arrays, in
JAX's order and dtypes, for the same seed.
"""

from __future__ import annotations

import gzip

import numpy as np
import pytest

from sctools_tpu import native as jax_native
from sctools_tpu.utils import make_synthetic_columns as jax_columns
from sctools_tpu_torch import native
from sctools_tpu_torch.ingest import ring_frames
from sctools_tpu_torch.utils import make_synthetic_columns


def _inflated(path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kwargs", [
    dict(n_cells=30),
    dict(n_cells=17, molecules_per_cell=3, reads_per_molecule=5, n_genes=9, seq_len=40, seed=11),
    dict(n_cells=12, cell_offset=1000, compress_level=6, seed=0),
])
def test_synth_bam_gives_jax_records(tmp_path, kwargs):
    before = native.calls["synth_bam"]
    written = native.synth_bam_native(str(tmp_path / "port.bam"), **kwargs)
    assert native.calls["synth_bam"] == before + 1
    assert written == jax_native.synth_bam_native(str(tmp_path / "jax.bam"), **kwargs)
    assert written == kwargs["n_cells"] * kwargs.get("molecules_per_cell", 8) * kwargs.get("reads_per_molecule", 4)
    assert _inflated(tmp_path / "port.bam") == _inflated(tmp_path / "jax.bam")


def test_synth_bam_decodes_through_the_ring(tmp_path):
    path = str(tmp_path / "synth.bam")
    written = native.synth_bam_native(path, 25, molecules_per_cell=4, reads_per_molecule=2, seed=3)
    frames = ring_frames(path, 64)
    try:
        total = sum(frame.n_records for frame in frames)
    finally:
        frames.close()
    assert total == written == 200


def test_synth_bam_failure_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open for write"):
        native.synth_bam_native(str(tmp_path / "missing" / "x.bam"), 2)


@pytest.mark.parametrize("kwargs", [
    dict(n_records=1000, seed=0),
    dict(n_records=4097, n_cells=200, n_genes=70, n_umis=33, seed=5),
    dict(n_records=300, seed=9, pad=False),
])
def test_make_synthetic_columns_gives_jax_arrays(kwargs):
    port, jax = make_synthetic_columns(**kwargs), jax_columns(**kwargs)
    assert list(port) == list(jax)
    for name in jax:
        assert port[name].dtype == jax[name].dtype, name
        assert np.array_equal(port[name], jax[name]), name
