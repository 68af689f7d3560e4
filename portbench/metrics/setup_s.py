"""Seconds from the process's start to the window's: imports, the model
built and loaded from the seed, the warm-up pass, and in a checkout's first
run the kernels' build (whose seconds the run also logs apart on standard
error)."""


def read(run):
    return run.setup_s
