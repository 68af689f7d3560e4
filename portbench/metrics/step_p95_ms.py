"""The 95th percentile of every sampler step of the window, in milliseconds
on the device stream (CUDA events from the benchmark's hooks, portbench/trace.py)."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if run.step_ms else None
