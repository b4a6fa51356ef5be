"""Whitelist correction: hamming <= 1 barcode matching on a CUDA kernel.

The port of ``sctools_tpu/ops/whitelist.py``. The function is the JAX
package's (and the reference hash map's, src/sctools/barcode.py:310-335):

- a base is one of the uppercase letters A/C/G/T, code 0-3; anything else
  (N, lowercase, padding) is code 4 and can never match, on either side;
- a whitelist barcode is a hit for a query when at most one position fails
  to match, i.e. when the one-hot score is at least L - 1;
- the hit with the largest whitelist index wins (the last entry in file
  order, as the reference's dict overwrites earlier entries), and a query
  with no hit gets -1;
- a query whose length differs from the whitelist's never corrects
  (ops/whitelist.py:350-354), which the corrector applies on the host.

Two versions of the one function, on the same inputs (a uint8 code block
``[n_q, L]`` and a ``WhitelistTable``):

- ``correct_plain``: the torch twin of ``_correct_jnp`` (:109-122), one-hot
  f32 and ``torch.matmul``, walking the whitelist in chunks with a running
  max so it never builds the ``[n_q, n_w]`` score matrix;
- ``correct_codes``: the wrapper. A CPU tensor goes to ``correct_plain``; a
  CUDA tensor goes to the hand-written kernel ``csrc/whitelist_correct.cu``
  (the port of the Pallas kernel ``_pallas_kernel``, :125-145) or the call
  raises. There is no fallback from the kernel to the plain version.

The kernel computes the same one-hot product on the tensor cores, in int8:
it reads ``[rows, Kpad]`` int8 one-hot tables (``onehot_int8``), the
whitelist's built once by ``make_table`` and the queries' expanded per batch
by the wrapper.

The whitelist's device table is cached by content hash (:200-238), so
correctors rebuilt over the same whitelist reuse one upload.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import ingest, kernels
from ..analysis.witness import make_lock
from ..device import DeviceLike, resolve

Barcodes = Sequence[Union[str, bytes]]

# byte value -> base code (A=0 C=1 G=2 T=3); 4 = N/other. Uppercase only:
# the reference's mutation map is case-sensitive, so a soft-masked base
# behaves like N.
_COL_LUT = np.full(256, 4, dtype=np.uint8)
for _col, _base in enumerate(b"ACGT"):
    _COL_LUT[_base] = _col
del _col, _base

# whitelist rows per step of the plain version: [n_q, PLAIN_CHUNK] f32
# scores at a time (4 GiB at n_q = 65,536) instead of [n_q, n_w]
PLAIN_CHUNK = 16384

# the kernel is built for one-hot rows of up to 8 k-steps of 32 bytes (wgmma
# k32 in int8): barcodes of up to 64 bases
KERNEL_MAX_LENGTH = 64
_K_STEP = 32

# the C entry point whitelist_correct(q_onehot, n_q, length, w_onehot, n_w,
# out, stream), which returns cudaGetLastError()
_KERNEL_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


def _codes_and_lengths(barcodes: Barcodes, length: int) -> Tuple[np.ndarray, np.ndarray]:
    n = len(barcodes)
    raw = [b.encode("latin-1") if isinstance(b, str) else b for b in barcodes]
    lengths = np.fromiter(map(len, raw), dtype=np.int64, count=n)
    if n == 0:
        return np.zeros((0, length), dtype=np.uint8), lengths
    if (lengths == length).all():
        joined = b"".join(raw)
    else:
        joined = b"".join(b[:length].ljust(length, b"\0") for b in raw)
    codes = _COL_LUT[np.frombuffer(joined, dtype=np.uint8)].reshape(n, length)
    return codes, lengths


def barcode_codes(barcodes: Barcodes, length: int) -> np.ndarray:
    """[n, length] uint8 base codes (A=0 C=1 G=2 T=3, 4 = N/other).

    Barcodes are cut or padded (with code 4) to ``length``, as in the JAX
    package's ``barcode_codes`` (:79-93). Accepts str or bytes.
    """
    return _codes_and_lengths(barcodes, length)[0]


def onehot_codes(codes: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[n, L] codes -> [n, 4L] one-hot of ``dtype``; code 4 gives a zero group."""
    eq = codes[:, :, None] == torch.arange(4, dtype=codes.dtype, device=codes.device)
    return eq.reshape(codes.shape[0], -1).to(dtype)


def onehot_width(length: int) -> int:
    """Kpad: the kernel's row width in bytes, 4L rounded up to a 32-byte k-step."""
    return _K_STEP * -(-4 * length // _K_STEP)


def onehot_int8(codes: torch.Tensor) -> torch.Tensor:
    """[n, L] codes -> [n, Kpad] int8 one-hot, the kernel's layout.

    The columns of ``onehot_codes`` as 0/1 bytes, then zero columns up to
    ``onehot_width(L)``; code 4 gives a zero group, as in the JAX package's
    ``onehot_barcodes`` (:60-76).
    """
    length = codes.shape[1]
    onehot = onehot_codes(codes, torch.int8)
    return torch.nn.functional.pad(onehot, (0, onehot_width(length) - 4 * length))


class WhitelistTable(NamedTuple):
    """The whitelist as it lives on the device.

    ``codes``: uint8 ``[n_w, L]`` base codes, which the plain version
    expands to one-hot chunk by chunk; ``onehot``: int8 ``[n_w, Kpad]``
    (``onehot_int8``), which the kernel reads.
    """

    codes: torch.Tensor
    onehot: torch.Tensor
    length: int


def make_table(codes: torch.Tensor) -> WhitelistTable:
    """The table of a whitelist given as a uint8 ``[n_w, L]`` code block."""
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise ValueError("whitelist codes must be a uint8 [n_w, L] tensor")
    codes = codes.contiguous()
    return WhitelistTable(codes, onehot_int8(codes), int(codes.shape[1]))


def correct_plain(
    queries: torch.Tensor, table: WhitelistTable, chunk: int = PLAIN_CHUNK
) -> torch.Tensor:
    """int32 [n_q]: the largest whitelist index within hamming 1, or -1.

    The torch twin of ``_correct_jnp``: one-hot dot products (exact in
    float32: at most 4L terms of 0 or 1) thresholded at L - 1, with a
    running max over whitelist chunks.
    """
    n_q = queries.shape[0]
    device = queries.device
    best = torch.full((n_q,), -1, dtype=torch.int32, device=device)
    if n_q == 0:
        return best
    q_onehot = onehot_codes(queries)
    n_w = table.codes.shape[0]
    for start in range(0, n_w, chunk):
        w_onehot = onehot_codes(table.codes[start : start + chunk])
        hits = torch.matmul(q_onehot, w_onehot.T) >= (table.length - 1)
        index = torch.arange(
            start, start + w_onehot.shape[0], dtype=torch.int32, device=device
        )
        chunk_best = torch.where(hits, index, -1).amax(dim=1)
        best = torch.maximum(best, chunk_best)
    return best


def correct_codes(queries: torch.Tensor, table: WhitelistTable) -> torch.Tensor:
    """int32 [n_q] whitelist index per query code row (-1 = no hit).

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``kernels.launches``); on a CPU tensor it runs ``correct_plain``.
    """
    if queries.dtype != torch.uint8 or queries.dim() != 2:
        raise ValueError("queries must be a uint8 [n_q, L] tensor")
    if queries.shape[1] != table.length:
        raise ValueError(
            f"queries have length {queries.shape[1]}, the whitelist {table.length}"
        )
    if queries.device != table.codes.device:
        raise ValueError(
            f"queries on {queries.device} but the whitelist on {table.codes.device}"
        )
    if queries.device.type == "cpu":
        return correct_plain(queries, table)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    if not (queries.is_contiguous() and table.onehot.is_contiguous()):
        raise ValueError("the kernel takes contiguous queries and table")
    if table.length > KERNEL_MAX_LENGTH:
        raise ValueError(
            f"the kernel is built for barcodes of at most {KERNEL_MAX_LENGTH} "
            f"bases, not {table.length}"
        )
    n_q = queries.shape[0]
    out = torch.empty(n_q, dtype=torch.int32, device=queries.device)
    if n_q == 0:
        return out
    entry = kernels.library("whitelist_correct").whitelist_correct
    entry.argtypes = _KERNEL_ARGTYPES
    entry.restype = ctypes.c_int
    with torch.cuda.device(queries.device):
        # the query side of the product, expanded on the device as the JAX
        # package does outside its Pallas call (:166); torch ops, no kernel
        # of the port
        q_onehot = onehot_int8(queries)
        stream = torch.cuda.current_stream().cuda_stream
        status = entry(
            q_onehot.data_ptr(), n_q, table.length, table.onehot.data_ptr(),
            table.onehot.shape[0], out.data_ptr(), stream,
        )
    kernels.check("whitelist_correct", status)
    kernels.launches["whitelist_correct"] += 1
    return out


# device-resident whitelist tables, content-hash-keyed (JAX :200-238):
# correctors rebuilt over the same whitelist reuse the uploaded table.
# Bounded small; the oldest entry goes first.
_TABLE_CACHE_MAX = 4
_table_lock = make_lock("ops.whitelist_table")
_table_cache: dict = {}


def _device_table(rows: np.ndarray, device: torch.device) -> WhitelistTable:
    """The table of a whitelist given as its ``[n_w, L]`` uint8 bytes."""
    key = (hashlib.sha256(rows.tobytes()).hexdigest(), rows.shape, str(device))
    with _table_lock:
        cached = _table_cache.get(key)
    if cached is not None:
        return cached
    table = make_table(ingest.upload(_COL_LUT[rows], device))
    with _table_lock:
        if len(_table_cache) >= _TABLE_CACHE_MAX:
            _table_cache.pop(next(iter(_table_cache)))
        _table_cache[key] = table
    return table


def correction_summary(total: int, correct: int, corrected: int, uncorrectable: int) -> str:
    """The reference's summary of a correction run, as the JAX native routes
    print it to stderr (native/__init__.py:1020-1030): raw barcodes already
    whitelisted, corrected, and left uncorrectable."""
    return (
        f"Total barcodes:{total}\n correct:{correct}\ncorrected:{corrected}\n"
        f"uncorrectible:{uncorrectable}\nuncorrected:{uncorrectable / total * 100.0:f}"
    )


class PendingCorrection:
    """A batch's correction in flight; ``indices()`` waits for its result."""

    def __init__(self, pulled: ingest.Pulled, length_ok: np.ndarray):
        self._pulled = pulled
        self._length_ok = length_ok

    def indices(self) -> np.ndarray:
        result = self._pulled.numpy()
        # a query of another length never corrects (JAX :350-354): the
        # reference hash map holds only whitelist-length keys
        return np.where(self._length_ok, result, -1).astype(np.int32)


class WhitelistCorrector:
    """Batch barcode corrector: the port of the JAX ``WhitelistCorrector``.

    Build once from the whitelist; ``correct`` maps raw barcodes to
    whitelisted ones (None where nothing is within hamming distance 1).
    Runs on ``cuda`` unless ``device="cpu"`` is passed.
    """

    def __init__(self, whitelist: Sequence[str], device: DeviceLike = None):
        whitelist = list(whitelist)
        if not whitelist:
            raise ValueError("whitelist must not be empty")
        self._length = len(whitelist[0])
        if set(map(len, whitelist)) != {self._length}:
            raise ValueError("whitelist barcodes must share one length")
        self._whitelist = whitelist
        # one join for the whole list: a per-barcode encode was most of
        # the load of a 737,280-barcode whitelist
        self._rows = np.frombuffer(
            "".join(whitelist).encode("latin-1"), dtype=np.uint8
        ).reshape(-1, self._length)
        self._device = resolve(device)
        self._table = _device_table(self._rows, self._device)

    @classmethod
    def from_file(cls, whitelist_file: str, **kwargs) -> "WhitelistCorrector":
        with open(whitelist_file) as fileobj:
            return cls([line for line in map(str.strip, fileobj) if line], **kwargs)

    @property
    def barcode_length(self) -> int:
        return self._length

    @property
    def whitelist(self) -> List[str]:
        return self._whitelist

    @property
    def rows(self) -> np.ndarray:
        """The whitelist as an ``[n_w, L]`` uint8 block of its bytes, row i
        barcode i: what a corrected index reads."""
        return self._rows

    def submit(self, barcodes: Barcodes) -> PendingCorrection:
        """Queue one batch: one upload, one kernel launch, one pull.

        Returns at once on CUDA; the host may prepare the next batch
        while this one runs.
        """
        codes, lengths = _codes_and_lengths(barcodes, self._length)
        return self._submit_codes(codes, lengths)

    def submit_block(self, block: np.ndarray, lengths: np.ndarray) -> PendingCorrection:
        """``submit`` of a fixed-width batch: ``block`` is ``[n, L]`` uint8
        barcode bytes (padding past a barcode's length never matches),
        ``lengths`` each barcode's length."""
        if block.dtype != np.uint8 or block.ndim != 2 or block.shape[1] != self._length:
            raise ValueError(f"barcodes must be a uint8 [n, {self._length}] block")
        return self._submit_codes(_COL_LUT[block], np.asarray(lengths))

    def _submit_codes(self, codes: np.ndarray, lengths: np.ndarray) -> PendingCorrection:
        queries = ingest.upload(codes, self._device)
        result = correct_codes(queries, self._table)
        return PendingCorrection(ingest.pull(result), lengths == self._length)

    def correct_indices(self, barcodes: Barcodes) -> np.ndarray:
        """int32 whitelist index per query (-1 = uncorrectable)."""
        if len(barcodes) == 0:
            return np.zeros(0, dtype=np.int32)
        return self.submit(barcodes).indices()

    def correct(self, barcodes: Barcodes) -> List[Optional[str]]:
        """Corrected barcode per query, None where uncorrectable."""
        indices = self.correct_indices(barcodes)
        return [self._whitelist[i] if i >= 0 else None for i in indices]
