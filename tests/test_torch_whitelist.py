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


# the kernel's tiling (csrc/whitelist_correct.cu): kCols whitelist rows per
# consumer warpgroup (the wgmma N), kConsumers of them per CTA, jobs of 64
# query rows (the wgmma M), and pipeline stages of 512, 256 or 128 query
# rows, the most of which two fit in shared memory beside the whitelist slice
KERNEL_COLS, KERNEL_CONSUMERS, WGMMA_M = 128, 4, 64
SMEM_ROOM = 232448 - 1024 - 256


def _stage_rows(kpad):
    room = SMEM_ROOM - KERNEL_COLS * KERNEL_CONSUMERS * kpad
    return next(rows for rows in (512, 256, 128) if room // (rows * kpad) >= 2 or rows == 128)


def _fragment_index(cols):
    """wgmma's accumulator layout for a 64 x cols tile: (row, col) of register
    i of thread t, as two [128, cols / 2] arrays."""
    t = np.arange(128)[:, None]
    i = np.arange(cols // 2)[None, :]
    warp, lane = t // 32, t % 32
    row = 16 * warp + lane // 4 + 8 * ((i // 2) % 2)
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return row, col


def _kernel_emulation(q_onehot, w_onehot, length, cols=KERNEL_COLS,
                      consumers=KERNEL_CONSUMERS, stage_rows=None):
    """The kernel's arithmetic, in numpy, on its int8 [rows, Kpad] tables.

    TMA zero-fills the rows past each table's end up to whole stages and
    whole CTA slices; each consumer's 64 x cols job is an int32 product; a
    thread takes the max of its fragment and, only when that reaches L - 1,
    atomicMaxes each in-bounds hit into the output, which starts at -1.
    """
    q_onehot, w_onehot = np.asarray(q_onehot), np.asarray(w_onehot)
    assert q_onehot.dtype == w_onehot.dtype == np.int8
    n_q, n_w = len(q_onehot), len(w_onehot)
    if stage_rows is None:
        stage_rows = _stage_rows(q_onehot.shape[1])
    slice_rows = cols * consumers
    q = np.zeros((-(-n_q // stage_rows) * stage_rows, q_onehot.shape[1]), dtype=np.int32)
    q[:n_q] = q_onehot
    w = np.zeros((-(-n_w // slice_rows) * slice_rows, w_onehot.shape[1]), dtype=np.int32)
    w[:n_w] = w_onehot
    row_of, col_of = _fragment_index(cols)
    out = np.full(n_q, -1, dtype=np.int32)
    for c0 in range(0, len(w), cols):  # every consumer of every CTA
        for r0 in range(0, len(q), WGMMA_M):  # its jobs, over every stage
            scores = q[r0 : r0 + WGMMA_M] @ w[c0 : c0 + cols].T
            fragments = scores[row_of, col_of]
            for t in np.flatnonzero(fragments.max(axis=1) >= length - 1):
                rows, hit_cols = r0 + row_of[t], c0 + col_of[t]
                hit = (fragments[t] >= length - 1) & (rows < n_q) & (hit_cols < n_w)
                np.maximum.at(out, rows[hit], hit_cols[hit].astype(np.int32))
    return out


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
    q_onehot = port_whitelist.onehot_int8(codes)
    np.testing.assert_array_equal(
        _kernel_emulation(q_onehot, table.onehot, length),
        port_whitelist.correct_plain(codes, table).numpy(),
    )
    kpad = 32 * -(-4 * length // 32)
    assert port_whitelist.onehot_width(length) == kpad
    assert table.onehot.dtype == q_onehot.dtype == torch.int8
    assert table.onehot.shape == (40, kpad) and q_onehot.shape == (len(queries), kpad)
    assert not table.onehot[:, 4 * length :].any()  # zero pad columns
    assert _stage_rows(kpad) == {32: 512, 64: 512, 96: 512, 128: 512, 160: 256, 192: 256,
                                 224: 256, 256: 128}[kpad]


@pytest.mark.parametrize("tiles", [(8, 2, 64), (24, 3, 128)])
@pytest.mark.parametrize("length", [1, 16, 64])
def test_kernel_emulation_with_small_tiles_matches_jax(length, tiles):
    # n_w and n_q are off every multiple of the tiles: ragged last slices
    # and stages on both sides
    cols, consumers, stage_rows = tiles
    rng = np.random.default_rng(length * 100 + cols)
    whitelist = _barcodes(rng, 5 * cols * consumers + 7, length)
    queries = [q.ljust(length, "A")[:length] for q in _mixed_queries(rng, whitelist, per_kind=30)]
    whitelist[1] = "N" * length
    whitelist[-1] = whitelist[2]  # a duplicate: the last copy wins
    queries = queries[: 2 * stage_rows + 37] + [whitelist[2]]
    table = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, length))
    )
    codes = torch.from_numpy(port_whitelist.barcode_codes(queries, length))
    got = _kernel_emulation(port_whitelist.onehot_int8(codes), table.onehot, length, *tiles)
    assert got.dtype == np.int32
    assert np.array_equal(got, port_whitelist.correct_plain(codes, table).numpy())
    for route in ("jnp", "pallas"):
        assert np.array_equal(got, _jax_indices(whitelist, queries, route).astype(np.int32))
    assert got[-1] == len(whitelist) - 1
    assert (got >= 0).sum() > len(queries) // 4


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("length", [14, LENGTH])
def test_onehot_table_matches_jax_onehot(pad, length):
    rng = np.random.default_rng(length)
    whitelist = _barcodes(rng, 50, length)
    whitelist[4] = whitelist[4][:3] + "N" + whitelist[4][4:]
    w_onehot = jax_whitelist.onehot_barcodes(whitelist, length)
    if pad:  # the Pallas route's table: zero rows up to a multiple of 2048
        w_onehot = jax_whitelist._pad_rows(w_onehot, 2048)
    kpad = port_whitelist.onehot_width(length)
    expected = np.zeros((len(w_onehot), kpad), dtype=np.int8)
    expected[:, : 4 * length] = w_onehot.astype(np.int8)
    from_jax = state.table_from_jax(w_onehot, length, device="cpu")
    np.testing.assert_array_equal(from_jax.onehot.numpy(), expected)
    own = port_whitelist.make_table(
        torch.from_numpy(port_whitelist.barcode_codes(whitelist, length))
    )
    np.testing.assert_array_equal(own.onehot.numpy(), expected[: len(whitelist)])


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
