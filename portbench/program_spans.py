"""The program's own spans, read from its ring (the port's
mvdfusion_tpu_torch/utils/trace.py: `sample.pass`, `sample.step`,
`model.gridattn`, `model.unet`), for the readers of host_step_ms,
device_step_ms, own_launches_per_step, host_unet_ms and host_gridattn_ms.

The module is looked up in sys.modules, never imported: program.py and
portbench/archs/ stay the benchmark's only modules that import the port,
and a program that never loaded such a module (one without it) gives None,
which leaves the metric out. The window's passes are the last len(run.passes) sampler passes
recorded with no profiler running: the warm-up pass came before them, the
profiled pass ran under the profiler. Each entry runs one sampler pass a
served pass.
"""

from __future__ import annotations

import statistics
import sys

MODULE = "mvdfusion_tpu_torch.utils.trace"


def window_steps(run):
    """[(step record, [the records inside it])] of the window's passes, in
    order; None where the program has no ring or the ring lacks the
    window's passes."""
    mod = sys.modules.get(MODULE)
    if mod is None:
        return None
    passes = {}
    for r in mod.records():
        if r.pass_id is not None:
            passes.setdefault(r.pass_id, []).append(r)
    plain = [recs for _, recs in sorted(passes.items())
             if recs[0].name == "sample.pass" and recs[0].end_ns is not None and not recs[0].profiled]
    n = len(run.passes)
    if n == 0 or len(plain) < n:
        return None
    out = []
    for recs in plain[-n:]:
        for s in (r for r in recs if r.name == "sample.step"):
            out.append((s, [r for r in recs if r.step == s.step and r is not s]))
    return out or None


def median_over_steps(run, value):
    """The median over the window's steps of value(step, inside), None
    where there are no steps or value gives None."""
    steps = window_steps(run)
    if not steps:
        return None
    vals = [value(s, inside) for s, inside in steps]
    return None if any(v is None for v in vals) else statistics.median(vals)


def host_ms_inside(name: str):
    """value() for median_over_steps: the summed host ms of the step's
    `name` spans."""
    return lambda step, inside: sum(r.host_ms for r in inside if r.name == name)
