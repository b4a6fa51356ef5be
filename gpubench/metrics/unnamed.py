"""unnamed.<cells>: the share of the window, in percent, that the main
thread's named timers do not cover: 100 × (1 − their seconds / the
window). The keys of ``seconds`` that the command times on its main
thread, which do not overlap, by the end-to-end metric the cell reports
(``unnamed.fastq``: FastqProcess; ``unnamed.bam``: the metrics gatherer).
None where the program lacks one of them."""

MAIN_THREAD = {
    "fastq": ("read", "correct", "write", "open"),
    "bam": ("decode_wait", "pack", "dispatch", "wait", "csv", "start", "close", "carry"),
}


def read(run, part):
    keys = MAIN_THREAD.get(part)
    if keys is None or run.window_s <= 0 or any(key not in run.seconds for key in keys):
        return None
    return 100.0 * (1.0 - sum(run.seconds[key] for key in keys) / run.window_s)
