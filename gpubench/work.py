"""The yardstick of the rooflines: the peaks of the card and the bytes each
function needs, counted from the cell's own sizes.

A roofline share is the least time the card could take for the function's
work over the time its device work took. The work is what the function
needs for these inputs, each logical input byte read once and each output
byte written once, whatever an implementation reads again: so a design that
does less work than today's reads higher, never above 100%.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA's published memory bandwidth by product, at its full power limit
HBM_BYTES_PER_S = (
    ("H100 80GB HBM3", 3.35e12),  # H100 SXM5
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
)

# the cell metrics' logical input per record, in bytes: the CB, UB and GE
# keys (4 each), reference and position (4 each), the flag (2), NH (1), XF
# (1), the two perfect-barcode bits (1) and the four per-read quality
# summaries (4 each)
METRICS_RECORD_BYTES = 4 * 3 + 4 + 4 + 2 + 1 + 1 + 1 + 4 * 4
# and its output per cell: the CSV's columns, 8 bytes each
METRICS_COLUMNS = 35
METRICS_VALUE_BYTES = 8
# the whitelist correction's output per read: one int32 index
INDEX_BYTES = 4


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    for marker, rate in HBM_BYTES_PER_S:
        if marker in device_name:
            return rate
    return None


def whitelist_correct_bytes(reads: int, barcode_length: int) -> int:
    """Each read's barcode in, its whitelist index out. The whitelist is
    set-up state, which a design need not read per batch."""
    return reads * (barcode_length + INDEX_BYTES)


def metrics_pass_bytes(records: int, cells: int) -> int:
    return records * METRICS_RECORD_BYTES + cells * METRICS_COLUMNS * METRICS_VALUE_BYTES


def share(floor_bytes: int, seconds: float, device_name: str) -> Optional[float]:
    """Percent of the bandwidth roofline; None where there is nothing to
    read (no device time, an unknown card)."""
    rate = hbm_bytes_per_s(device_name)
    if rate is None or not seconds or seconds <= 0 or floor_bytes <= 0:
        return None
    return 100.0 * (floor_bytes / rate) / seconds
