"""The port's own kernels launched a sampler step: the mean over the
window's steps of the increase of ops/_lib.py's LAUNCHES that the
program's `sample.step` span stores, read from the program's ring
(portbench/program_spans.py). The rest of launches_per_step is aten's,
cuBLAS's and cuDNN's."""

from portbench import program_spans


def read(run):
    steps = program_spans.window_steps(run)
    return sum(s.launches for s, _ in steps) / len(steps) if steps else None
