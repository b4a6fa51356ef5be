"""metrics_pass.ms: device milliseconds (kernels, copies and fills, their
union in the trace) per million records of the window."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.units:
        return None
    return 1e3 * run.trace.busy_s / (run.units / 1e6)
