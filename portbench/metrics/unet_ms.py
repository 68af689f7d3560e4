"""Device milliseconds a step of the kernels launched inside the UNet's
call (portbench.unet spans from hooks on the UNet module) in the profiled
pass."""


def read(run):
    t = run.trace
    if not t or not t["steps"] or "unet" not in t["span_s"]:
        return None
    return 1e3 * t["span_s"]["unet"] / t["steps"]
