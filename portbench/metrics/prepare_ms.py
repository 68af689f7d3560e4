"""Milliseconds a scene of the entry's prepare phase (VAE encode, CLIP,
cameras), synchronised host spans, mean over the window's passes."""


def read(run):
    return 1e3 * sum(p["timings"]["prepare"] for p in run.passes) / (len(run.passes) * run.scenes_per_pass)
