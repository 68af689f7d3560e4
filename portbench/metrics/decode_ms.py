"""Milliseconds a scene of the entry's decode phase (the VAE decoder over
the targets, and the ground truth where the entry decodes it), synchronised
host spans, mean over the window's passes."""


def read(run):
    return 1e3 * sum(p["timings"]["decode"] for p in run.passes) / (len(run.passes) * run.scenes_per_pass)
