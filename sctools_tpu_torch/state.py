"""Carry the JAX package's device state across to the port.

The JAX whitelist corrector keeps its whitelist on the device as a one-hot
float32 table (``onehot_barcodes``, sctools_tpu/ops/whitelist.py:60-76,
staged by ``_device_table`` :211-238): ``[n_w, 4L]``, or ``[n_w`` padded to
a multiple of 2048 ``, 4L]`` on the Pallas route, with an all-zero row for
every padding row and a zero group of four for every N or non-ACGT base.

``table_from_jax`` turns that table into the port's ``WhitelistTable``. A
zero group becomes code 4, so a padding row becomes an all-N row; such a row
can never be a hit at L >= 2, which is the only case in which the JAX
package pads, so the port answers every query as the JAX table did.
"""

from __future__ import annotations

import numpy as np

from . import ingest
from .device import DeviceLike, resolve
from .ops.whitelist import WhitelistTable, make_table


def table_from_jax(
    w_onehot: np.ndarray, length: int, device: DeviceLike = None
) -> WhitelistTable:
    """The port's device table for a JAX one-hot whitelist table."""
    onehot = np.asarray(w_onehot)
    if onehot.ndim != 2 or onehot.shape[1] != 4 * length:
        raise ValueError(
            f"expected a [n_w, {4 * length}] one-hot table, got {onehot.shape}"
        )
    groups = onehot.reshape(onehot.shape[0], length, 4)
    if not np.isin(groups, (0.0, 1.0)).all() or (groups.sum(axis=2) > 1).any():
        raise ValueError("not a one-hot table: each base needs at most one 1")
    codes = np.where(groups.any(axis=2), groups.argmax(axis=2), 4).astype(np.uint8)
    return make_table(ingest.upload(codes, resolve(device)))
