"""fastq.<part>: seconds FastqProcess spent in one part of its loop, per
million reads of the window, from the program's own ``seconds[part]``:
``fastq.read`` reads and slices the FASTQ, ``fastq.correct`` is the
correction seam (submit, kernel, wait), ``fastq.write`` builds, compresses
and writes the shards."""


def read(run, part):
    value = run.seconds.get(part)
    return value / (run.units / 1e6) if value is not None and run.units else None
