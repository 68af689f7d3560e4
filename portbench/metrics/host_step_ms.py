"""Host milliseconds of a sampler step: the median over the window's steps
of the program's own `sample.step` span (its model call, ddim_step and the
clamp), read from the program's ring (portbench/program_spans.py)."""

from portbench import program_spans


def read(run):
    return program_spans.median_over_steps(run, lambda step, inside: step.host_ms)
