"""bam.decode_wait: seconds the gatherer's thread waited on the ingest
ring for decoded batches, per million records of the window
(``MetricGatherer.seconds["decode_wait"]``)."""


def read(run):
    value = run.seconds.get("decode_wait")
    return value / (run.units / 1e6) if value is not None and run.units else None
