"""The UNet's share of its roofline: the frozen bound of a step's one call
over the pass's scenes (the configuration's unet counts) over its measured
device time in the profiled pass, in percent."""

from portbench import yardstick


def read(run):
    t = run.trace
    if not t or not t["steps"] or not t["span_s"].get("unet"):
        return None
    return 100.0 * yardstick.call_bound_s(run.cell, "unet", run.scenes_per_pass) * t["steps"] / t["span_s"]["unet"]
