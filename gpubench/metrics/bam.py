"""bam.<part>: seconds the metrics gatherer spent in one part of its pass,
per million records of the window, from the program's own
``MetricGatherer.seconds[part]``: ``bam.decode`` is the ring's decode on
its thread, and of it ``bam.decode.read``, ``bam.decode.inflate`` and
``bam.decode.parse`` the native stream's file reads, block-parallel inflate
and the rest of its batches (the record scan, the parse, the vocabulary
merge), read from the stream's own clocks, and ``bam.decode.fill`` the
arena's fill and frame. None where the program has no such key."""


def read(run, part):
    value = run.seconds.get(part)
    return value / (run.units / 1e6) if value is not None and run.units else None
