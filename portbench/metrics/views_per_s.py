"""Target views served a second: the views of every pass that completed in
the window over the seconds from the window's start to the last completion."""


def read(run):
    views = len(run.passes) * run.scenes_per_pass * run.targets
    return views / run.window_s
