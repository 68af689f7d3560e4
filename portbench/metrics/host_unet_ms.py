"""Host milliseconds of the UNet's call in a sampler step: the median over
the window's steps of the program's `model.unet` span inside it, read
from the program's ring (portbench/program_spans.py)."""

from portbench import program_spans


def read(run):
    return program_spans.median_over_steps(run, program_spans.host_ms_inside("model.unet"))
