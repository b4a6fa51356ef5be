"""whitelist_correct_roofline: the whitelist kernel's share of the memory
roofline, in percent: the bytes the function needs for the window's reads
(``work.whitelist_correct_bytes``) at the card's bandwidth, over the
kernel's device time in the trace."""

from gpubench import work


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.device_s("whitelist_correct")
    return work.share(work.whitelist_correct_bytes(run.units, run.config["barcode_length"]), seconds,
                      run.device_name)
