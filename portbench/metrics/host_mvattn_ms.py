"""Host milliseconds of MVDream's joined self-attentions in a sampler step:
the median over the window's steps of the summed `model.mvattn` spans
inside it (16 a step), read from the program's ring
(portbench/program_spans.py); None where the window's steps hold none."""

from portbench import program_spans

NAME = "model.mvattn"


def read(run):
    steps = program_spans.window_steps(run)
    if not steps or not any(r.name == NAME for _, inside in steps for r in inside):
        return None
    return program_spans.median_over_steps(run, program_spans.host_ms_inside(NAME))
