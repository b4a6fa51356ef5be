"""The port's whitelist correction against the JAX package's, index for index.

Inputs are made with a numpy seed and go through both packages: the JAX
``WhitelistCorrector`` on its Pallas route (interpret mode on the CPU) and
on its jnp route, and the port's ``WhitelistCorrector`` with
``device="cpu"`` (the plain torch version). Indices must be equal exactly, as
int32. The kernel itself runs only on a card: its tests are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sctools_tpu.ops import whitelist as jax_whitelist
from sctools_tpu_torch import device as port_device
from sctools_tpu_torch import kernels, state
from sctools_tpu_torch.ops import whitelist as port_whitelist

LENGTH = 16
BASES = np.array(list("ACGT"))


def _barcodes(rng, n, length=LENGTH):
    return ["".join(row) for row in rng.choice(BASES, size=(n, length))]


def _mutate(rng, barcode, n_positions, alphabet="ACGT"):
    out = list(barcode)
    n_positions = min(n_positions, len(barcode))
    for p in rng.choice(len(barcode), size=n_positions, replace=False):
        out[p] = rng.choice([c for c in alphabet if c != out[p]])
    return "".join(out)


def _mixed_queries(rng, whitelist, per_kind=40):
    length = len(whitelist[0])
    pick = lambda: whitelist[rng.integers(len(whitelist))]  # noqa: E731
    queries = []
    for _ in range(per_kind):
        queries += [
            pick(),  # exact
            _mutate(rng, pick(), 1),  # one substitution
            _mutate(rng, pick(), 1, "N"),  # one N
            _mutate(rng, pick(), 2),  # two substitutions: usually no hit
            _mutate(rng, pick(), 2, "N"),  # two Ns: never a hit (at L >= 2)
            _barcodes(rng, 1, length)[0],  # random
            pick().lower(),  # soft-masked: every base acts as N
            pick()[:-1],  # one short
            pick() + "A",  # one long
        ]
    return queries


def _jax_indices(whitelist, queries, route):
    corrector = jax_whitelist.WhitelistCorrector(
        whitelist, use_pallas=route == "pallas", interpret=True
    )
    return np.asarray(corrector.correct_indices(queries))


def _port_indices(whitelist, queries):
    corrector = port_whitelist.WhitelistCorrector(whitelist, device="cpu")
    return corrector.correct_indices(queries)


def _assert_same(got, expected):
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, expected.astype(np.int32))


@pytest.fixture(scope="module")
def whitelist():
    return sorted(set(_barcodes(np.random.default_rng(23), 300)))


@pytest.mark.parametrize("route", ["pallas", "jnp"])
@pytest.mark.parametrize("length", [LENGTH, 14])
def test_matches_jax_on_mixed_queries(route, length):
    rng = np.random.default_rng(length)
    whitelist = _barcodes(rng, 300, length)
    queries = _mixed_queries(rng, whitelist)
    expected = _jax_indices(whitelist, queries, route)
    got = _port_indices(whitelist, queries)
    _assert_same(got, expected)
    assert (got >= 0).sum() > len(queries) // 4  # the mix has real hits


@pytest.mark.parametrize("route", ["pallas", "jnp"])
def test_two_n_never_matches(route, whitelist):
    rng = np.random.default_rng(5)
    queries = [_mutate(rng, whitelist[0], 2, "N") for _ in range(8)]
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, route))
    assert (got == -1).all()


@pytest.mark.parametrize("ordering", [0, 1])
def test_last_whitelist_entry_wins_on_ambiguity(ordering):
    base = "A" * LENGTH
    w1 = "C" + base[1:]
    w2 = base[:-1] + "G"
    entries = [w1, w2] if ordering == 0 else [w2, w1]
    query = "C" + base[1:-1] + "G"  # distance 1 from both
    got = _port_indices(entries, [query])
    _assert_same(got, _jax_indices(entries, [query], "jnp"))
    assert got.tolist() == [1]
    corrector = port_whitelist.WhitelistCorrector(entries, device="cpu")
    assert corrector.correct([query]) == [entries[-1]]


def test_duplicate_entries_last_wins():
    whitelist = ["ACGTACGTACGTACGT", "TTTTTTTTTTTTTTTT", "ACGTACGTACGTACGT"]
    queries = ["ACGTACGTACGTACGA", "ACGTACGTACGTACGT"]
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, "jnp"))
    assert got.tolist() == [2, 2]


def test_lowercase_query_is_case_sensitive():
    whitelist = ["ACGTA", "TTTTT"]
    queries = ["acgta", "aCGTA"]
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, "jnp"))
    assert got.tolist() == [-1, 0]  # one masked base acts as one N


def test_whitelist_entry_with_n():
    whitelist = ["ACGTNCGTACGTACGT", "GGGGGGGGGGGGGGGG"]
    queries = ["ACGTACGTACGTACGT", "ACGTNCGTACGTACGT", "ACGTNCGTACGTACGA"]
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, "pallas"))
    assert got.tolist() == [0, 0, -1]


@pytest.mark.parametrize("route", ["pallas", "jnp"])
def test_length_mismatched_queries_never_correct(route, whitelist):
    queries = [whitelist[0][:-1], whitelist[0] + "A", whitelist[0], ""]
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, route))
    assert got.tolist() == [-1, -1, 0, -1]


def test_empty_query_batch(whitelist):
    corrector = port_whitelist.WhitelistCorrector(whitelist, device="cpu")
    assert corrector.correct([]) == []
    assert corrector.correct_indices([]).dtype == np.int32


def test_length_one_every_pair_hits():
    whitelist = ["A", "C"]
    queries = ["G", "A", "N", "a", "", "AC"]
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, "jnp"))
    assert got.tolist() == [1, 1, 1, 1, -1, -1]


@pytest.mark.parametrize("chunk", [1, 7, 64, port_whitelist.PLAIN_CHUNK])
def test_plain_chunking_is_invisible(chunk, whitelist):
    rng = np.random.default_rng(chunk)
    queries = _mixed_queries(rng, whitelist, per_kind=10)
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, LENGTH))
    )
    codes = torch.from_numpy(port_whitelist.barcode_codes(queries, LENGTH))
    got = port_whitelist.correct_plain(codes, table, chunk=chunk).numpy()
    expected = np.asarray(
        jax_whitelist._correct_jnp(
            port_whitelist.barcode_codes(queries, LENGTH),
            jax_whitelist.onehot_barcodes(whitelist, LENGTH),
            LENGTH,
        )
    )
    _assert_same(got, expected)


def test_whitelist_larger_than_plain_chunk():
    rng = np.random.default_rng(77)
    whitelist = _barcodes(rng, port_whitelist.PLAIN_CHUNK + 3000)
    queries = _mixed_queries(rng, whitelist, per_kind=6)
    queries += [whitelist[-1], _mutate(rng, whitelist[-2], 1)]  # hits past the chunk
    got = _port_indices(whitelist, queries)
    _assert_same(got, _jax_indices(whitelist, queries, "jnp"))
    assert got[-2] == len(whitelist) - 1


@pytest.mark.parametrize("pad", [False, True])
def test_table_from_jax_answers_like_the_port_table(pad, whitelist):
    rng = np.random.default_rng(3)
    queries = _mixed_queries(rng, whitelist, per_kind=10)
    w_onehot = jax_whitelist.onehot_barcodes(whitelist, LENGTH)
    if pad:  # the Pallas route's table: zero rows up to a multiple of 2048
        w_onehot = jax_whitelist._pad_rows(w_onehot, 2048)
    table = state.table_from_jax(w_onehot, LENGTH, device="cpu")
    own = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, LENGTH))
    )
    codes = torch.from_numpy(port_whitelist.barcode_codes(queries, LENGTH))
    np.testing.assert_array_equal(
        port_whitelist.correct_codes(codes, table).numpy(),
        port_whitelist.correct_codes(codes, own).numpy(),
    )


def test_table_from_jax_rejects_a_non_onehot_table():
    with pytest.raises(ValueError):
        state.table_from_jax(np.full((3, 8), 0.5, dtype=np.float32), 2, device="cpu")
    with pytest.raises(ValueError):
        state.table_from_jax(np.zeros((3, 7), dtype=np.float32), 2, device="cpu")


def _kernel_emulation(queries, table):
    """The kernel's arithmetic on the packed words, in numpy: popc of
    ((x | x >> 1) & 0x5555...) | qN | wN summed over words, a hit at <= 1."""
    q = port_whitelist.pack_codes(queries).numpy().view(np.uint32).astype(np.uint64)
    w = table.packed.numpy().view(np.uint32).astype(np.uint64)
    words = q.shape[1] // 2
    mismatches = np.zeros((q.shape[0], w.shape[0]), dtype=np.int64)
    for k in range(words):
        x = q[:, None, k] ^ w[None, :, k]
        d = ((x | (x >> 1)) & 0x55555555) | q[:, None, words + k] | w[None, :, words + k]
        mismatches += np.vectorize(lambda v: bin(int(v)).count("1"))(d)
    hit = mismatches <= 1
    index = np.where(hit, np.arange(w.shape[0])[None, :], -1)
    return index.max(axis=1).astype(np.int32)


@pytest.mark.parametrize("length", [1, 14, 16, 17, 33, 49, 64])
def test_packed_layout_and_kernel_arithmetic_match_plain(length):
    rng = np.random.default_rng(100 + length)
    whitelist = _barcodes(rng, 40, length)
    whitelist[3] = "N" + whitelist[3][1:]
    queries = [q.ljust(length, "A")[:length] for q in _mixed_queries(rng, whitelist, per_kind=3)]
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, length))
    )
    codes = torch.from_numpy(port_whitelist.barcode_codes(queries, length))
    np.testing.assert_array_equal(
        _kernel_emulation(codes, table),
        port_whitelist.correct_plain(codes, table).numpy(),
    )
    assert table.packed.shape == (40, 2 * (-(-length // 16)))


def test_cuda_request_without_a_gpu_raises(monkeypatch, whitelist):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve()
    with pytest.raises(RuntimeError):
        port_whitelist.WhitelistCorrector(whitelist)
    with pytest.raises(RuntimeError):
        port_whitelist.WhitelistCorrector(whitelist, device="cuda")
    assert port_device.resolve("cpu") == torch.device("cpu")


def test_wrapper_checks_its_inputs(whitelist):
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, LENGTH))
    )
    with pytest.raises(ValueError):
        port_whitelist.correct_codes(torch.zeros((2, LENGTH), dtype=torch.int32), table)
    with pytest.raises(ValueError):
        port_whitelist.correct_codes(torch.zeros((2, LENGTH - 1), dtype=torch.uint8), table)
    before = dict(kernels.launches)
    port_whitelist.correct_codes(torch.zeros((2, LENGTH), dtype=torch.uint8), table)
    assert kernels.launches == before  # the CPU path launches no kernel
