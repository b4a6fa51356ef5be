"""The port's CUDA kernel and its attach path on the card, against the plain version.

Every test here needs an NVIDIA GPU: each carries the ``cuda`` marker and
skips, with its reason, where ``torch.cuda.is_available()`` is false. The
file imports neither JAX nor ``sctools_tpu`` and builds its own inputs, so
it also runs on a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The JAX comparisons of the same functions run on the CPU in
``test_torch_whitelist.py`` and ``test_torch_attach.py``.
"""

import numpy as np
import pytest
import torch

from sctools_tpu_torch import kernels
from sctools_tpu_torch import platform as port_platform
from sctools_tpu_torch.io.sam import AlignmentWriter, BamHeader, BamRecord
from sctools_tpu_torch.ops import whitelist as port_whitelist

pytestmark = pytest.mark.cuda

LETTERS = np.array(list("ACGT"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _barcodes(rng, n, length):
    return ["".join(row) for row in rng.choice(LETTERS, size=(n, length))]


def _queries(rng, whitelist, n):
    """Exact, one substitution, one N, random, lowercase, and short."""
    length = len(whitelist[0])
    out = []
    for i in range(n):
        barcode = whitelist[rng.integers(len(whitelist))]
        p = int(rng.integers(length))
        kind = i % 6
        if kind == 1:
            barcode = barcode[:p] + rng.choice([c for c in "ACGT" if c != barcode[p]]) + barcode[p + 1:]
        elif kind == 2:
            barcode = barcode[:p] + "N" + barcode[p + 1:]
        elif kind == 3:
            barcode = _barcodes(rng, 1, length)[0]
        elif kind == 4:
            barcode = barcode.lower()
        elif kind == 5:
            barcode = barcode[: length // 2]
        out.append(barcode)
    return out


@pytest.mark.parametrize("length", [1, 14, 16, 17, 33, 49, 64])
def test_kernel_matches_plain(cuda_device, length):
    rng = np.random.default_rng(length)
    whitelist = _barcodes(rng, 5000 + 13, length)  # off any tile multiple
    whitelist[7] = "N" + whitelist[7][1:]
    whitelist.append(whitelist[11])  # a duplicate: the last copy wins
    queries = _queries(rng, whitelist, 3001) + [whitelist[11]]
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, length)).to(cuda_device)
    )
    q = torch.from_numpy(port_whitelist.barcode_codes(queries, length)).to(cuda_device)
    before = kernels.launches["whitelist_correct"]
    got = port_whitelist.correct_codes(q, table)
    torch.cuda.synchronize()
    assert kernels.launches["whitelist_correct"] == before + 1
    expected = port_whitelist.correct_plain(q, table)
    np.testing.assert_array_equal(got.cpu().numpy(), expected.cpu().numpy())
    assert got[-1].item() == len(whitelist) - 1


def test_corrector_matches_on_cpu_and_card(cuda_device):
    rng = np.random.default_rng(3)
    whitelist = _barcodes(rng, 2000, 16)
    queries = _queries(rng, whitelist, 5000)
    on_card = port_whitelist.WhitelistCorrector(whitelist, device="cuda")
    on_cpu = port_whitelist.WhitelistCorrector(whitelist, device="cpu")
    np.testing.assert_array_equal(
        on_card.correct_indices(queries), on_cpu.correct_indices(queries)
    )


def test_wrapper_refuses_mixed_devices(cuda_device):
    whitelist = _barcodes(np.random.default_rng(4), 10, 16)
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, 16)).to(cuda_device)
    )
    with pytest.raises(ValueError):
        port_whitelist.correct_codes(torch.zeros((2, 16), dtype=torch.uint8), table)


def test_attach_on_the_card_matches_the_cpu(cuda_device, tmp_path, capsys):
    rng = np.random.default_rng(5)
    whitelist = _barcodes(rng, 100, 16)
    (tmp_path / "wl.txt").write_text("\n".join(whitelist) + "\n")
    n = 700
    r1 = [q.ljust(16, "A") + s for q, s in zip(_queries(rng, whitelist, n), _barcodes(rng, n, 12))]
    i1 = _barcodes(rng, n, 8)
    for name, reads in (("r1", r1), ("i1", i1)):
        with open(tmp_path / f"{name}.fastq", "w") as f:
            for i, seq in enumerate(reads):
                f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    header = BamHeader("@HD\tVN:1.6\tSO:unsorted\n")
    with AlignmentWriter(str(tmp_path / "u2.bam"), header) as out:
        for i, seq in enumerate(_barcodes(rng, n, 50)):
            out.write(BamRecord(query_name=f"r{i}", sequence=seq, quality=[30] * 50))

    outputs, errors = [], []
    for device in ("cpu", "cuda"):
        output = str(tmp_path / f"{device}.bam")
        before = kernels.launches["whitelist_correct"]
        capsys.readouterr()
        port_platform.TenXV2.attach_barcodes(
            ["--r1", str(tmp_path / "r1.fastq"), "--u2", str(tmp_path / "u2.bam"),
             "--i1", str(tmp_path / "i1.fastq"), "-o", output, "-w", str(tmp_path / "wl.txt")],
            device=device,
        )
        errors.append(capsys.readouterr().err)
        assert kernels.launches["whitelist_correct"] == before + (device == "cuda")
        with open(output, "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    assert errors[0] == errors[1] and "Total barcodes:700" in errors[0]
