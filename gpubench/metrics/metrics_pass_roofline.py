"""metrics_pass_roofline: the cell metrics' device pass's share of the
memory roofline, in percent: the bytes the function needs for the window's
records and CSV rows (``work.metrics_pass_bytes``) at the card's bandwidth,
over the device time in the trace."""

from gpubench import work


def read(run):
    if run.trace is None or "barcodes" not in run.counts:
        return None
    rows = run.counts["barcodes"]  # one CSV row a barcode, over the window's passes
    return work.share(work.metrics_pass_bytes(run.units, rows), run.trace.busy_s, run.device_name)
