"""bam.pack: seconds the gatherer spent packing batches and dispatching
them (upload and enqueue of the device pass), per million records of the
window (``seconds["pack"] + seconds["dispatch"]``)."""


def read(run):
    pack, dispatch = run.seconds.get("pack"), run.seconds.get("dispatch")
    if pack is None or dispatch is None or not run.units:
        return None
    return (pack + dispatch) / (run.units / 1e6)
