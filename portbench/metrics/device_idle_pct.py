"""The share of the untraced window's wall time a pass in which no
operation ran on the card: 1 - (the profiled pass's device-busy seconds)
over (the untraced window's seconds a pass), in percent. The profiler slows
the host, so the busy time comes from the trace and the wall from the
window."""


def read(run):
    t = run.trace
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["passes"]) / (run.window_s / len(run.passes)))
