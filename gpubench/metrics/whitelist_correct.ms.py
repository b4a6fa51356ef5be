"""whitelist_correct.ms: device milliseconds per launch of the whitelist
kernel: the trace's kernels named ``whitelist_correct*`` over the launches
the program counted in the window."""


def read(run):
    launches = run.launches.get("whitelist_correct", 0)
    if run.trace is None or not launches:
        return None
    seconds = run.trace.device_s("whitelist_correct")
    return 1e3 * seconds / launches if seconds > 0 else None
