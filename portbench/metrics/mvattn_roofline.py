"""The joined self-attentions' share of their roofline: the frozen bound
of a step's 16 attn1 calls over the pass's requests (the configuration's
mvattn counts: K2 at the joined shape with the projections around it) over
their measured device time in the profiled pass, in percent."""

from portbench import yardstick


def read(run):
    t = run.trace
    if not t or not t["steps"]:
        return None
    s = sum(v for name, v in t["span_s"].items() if name.startswith("mvattn."))
    if not s:
        return None
    return 100.0 * yardstick.call_bound_s(run.cell, "mvattn", run.scenes_per_pass) * t["steps"] / s
