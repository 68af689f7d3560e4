"""Stream milliseconds of a sampler step: the median over the window's steps
of the interval between the CUDA events the program's `sample.step` span
records at the step's boundaries, read from the program's ring
(portbench/program_spans.py); nothing off a CUDA device."""

from portbench import program_spans


def read(run):
    return program_spans.median_over_steps(run, lambda step, inside: step.device_ms())
