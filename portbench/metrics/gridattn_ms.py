"""Device milliseconds a step of the kernels launched inside GridAttn's
calls (portbench.gridattn spans from hooks on ViewFusion.view_attn) in the
profiled pass."""


def read(run):
    t = run.trace
    if not t or not t["steps"] or "gridattn" not in t["span_s"]:
        return None
    return 1e3 * t["span_s"]["gridattn"] / t["steps"]
