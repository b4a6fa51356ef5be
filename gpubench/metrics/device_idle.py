"""device_idle.<cells>: the share of the traced window in which no kernel,
copy or fill ran on the card, in percent. One reader for the names the
quantity takes in cells that report different end-to-end metrics
(``device_idle.fastq``, ``device_idle.bam``)."""


def read(run, part=""):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
