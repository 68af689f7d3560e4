"""Device milliseconds a step of the kernels launched inside MVDream's
joined self-attentions (the portbench.mvattn.<i> spans from hooks on the
16 sites' attn1 modules, portbench/archs/mvdream.py) in the profiled
pass, summed over the sites."""


def read(run):
    t = run.trace
    if not t or not t["steps"]:
        return None
    s = sum(v for name, v in t["span_s"].items() if name.startswith("mvattn."))
    return 1e3 * s / t["steps"] if s else None
