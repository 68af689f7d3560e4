"""Device kernels launched inside the sampler steps of the profiled pass,
over its steps (launches whose host call fell inside a portbench.step span)."""


def read(run):
    t = run.trace
    if not t or not t["steps"] or "step" not in t["span_launches"]:
        return None
    return t["span_launches"]["step"] / t["steps"]
