"""GridAttn's share of its roofline: the frozen bound of a step's calls
(one a scene; the configuration's gridattn counts) over their measured
device time in the profiled pass, in percent."""

from portbench import yardstick


def read(run):
    t = run.trace
    if not t or not t["steps"] or not t["span_s"].get("gridattn"):
        return None
    N = run.scenes_per_pass
    return 100.0 * yardstick.call_bound_s(run.cell, "gridattn", 1, calls=N) * t["steps"] / t["span_s"]["gridattn"]
