"""Share of GridAttn's calls that replayed a CUDA graph, in %: the
program's `gridattn.replay` spans over its `model.gridattn` spans in the
window's steps, read from the program's ring (portbench/program_spans.py).
None where the ring records no graph span at all: a program that never
graphs GridAttn (one without the graph path, or a run on the CPU)."""

import sys

from portbench import program_spans

GRAPH_SPANS = ("gridattn.capture", "gridattn.replay")


def read(run):
    steps = program_spans.window_steps(run)
    if not steps or not any(r.name in GRAPH_SPANS for r in sys.modules[program_spans.MODULE].records()):
        return None
    names = [r.name for _, inside in steps for r in inside]
    calls = names.count("model.gridattn")
    return 100.0 * names.count("gridattn.replay") / calls if calls else None
