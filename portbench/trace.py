"""The benchmark's own marks on the program: CUDA events at each sampler
step, and record_function spans around the layers' calls in a traced pass,
both from forward hooks on the program's modules (program.modules); and
the reduction of a torch.profiler trace to kernel time by span.

Steps. A step starts at the first GridAttn call after the UNet has run
(or after the pass began) and ends where the next starts, or at the first
VAE decoder call after it (the end of sampling). Each start and end is a
CUDA event on the current stream, read once after the window, never
synchronised inside it.

Spans. In a traced pass the hooks open "portbench.<name>" around each call
of the modules program.modules names, and "portbench.step" around each
step. `summarize` attributes every kernel to the spans that were open on
the host when it was launched (the launch's correlation id), and labels
each gap between device operations by what the host was running then.
"""

from __future__ import annotations

import bisect
import collections
import json
import time

import torch

from portbench import program

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Marks:
    """Forward hooks on the program's modules: step events always, spans
    while `spans` is set."""

    def __init__(self, model, device):
        self.cuda = torch.device(device).type == "cuda"
        self.passes = []  # per pass: [(kind, stamp)], kind "start" or "end"
        self.want_step = False
        self.open_step = False
        self.spans = False
        self._open = {}
        self._handles = []
        mods = program.modules(model)
        # the step's hooks first, so that a step's span closes before the next call's opens
        self._handles.append(mods["gridattn"].register_forward_pre_hook(self._gridattn))
        self._handles.append(mods["unet"].register_forward_hook(self._unet_done))
        self._handles.append(mods["vae_decode"].register_forward_pre_hook(self._decode))
        for name, mod in mods.items():
            self._handles.append(mod.register_forward_pre_hook(self._enter(name)))
            self._handles.append(mod.register_forward_hook(self._exit(name)))

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _span(self, name: str, on: bool):
        if on:
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._open[name] = rf
        elif name in self._open:
            self._open.pop(name).__exit__(None, None, None)

    def _enter(self, name):
        def hook(_m, _args):
            if self.spans:
                self._span(name, True)
        return hook

    def _exit(self, name):
        def hook(_m, _args, _out):
            if self.spans:
                self._span(name, False)
        return hook

    def _close_step(self):
        if self.open_step:
            if self.spans:
                self._span("step", False)
            self.passes[-1].append(("end", self._stamp()))
            self.open_step = False

    def _gridattn(self, _m, _args):
        if self.want_step:
            self._close_step()
            self.want_step = False
            if self.spans:
                self._span("step", True)
            self.passes[-1].append(("start", self._stamp()))
            self.open_step = True

    def _unet_done(self, _m, _args, _out):
        self.want_step = True

    def _decode(self, _m, _args):
        self._close_step()
        self.want_step = False

    def begin_pass(self):
        self.passes.append([])
        self.want_step, self.open_step = True, False

    def end_pass(self):
        self._close_step()
        self.want_step = False

    def step_ms(self) -> list:
        """Every step's milliseconds, pass by pass (synchronises once)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for marks in self.passes:
            for (kind, a), (_, b) in zip(marks, marks[1:]):
                if kind == "start":
                    out.append(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
        return out


def _intervals(events):
    iv = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events)
    return [a for a, _ in iv], iv


def _inside(index, t):
    starts, iv = index
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and iv[i][0] <= t <= iv[i][1]


def summarize(path: str) -> dict:
    """Kernel time and launches by span, busy time, the top device
    operations and the longest idle gaps by host activity, from a chrome
    trace that torch.profiler exported. Times in seconds."""
    with open(path) as fp:
        events = [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans[e["name"][len(PREFIX):]].append(e)
    index = {k: _intervals(v) for k, v in spans.items()}
    span_s = collections.Counter()
    span_launches = collections.Counter()
    for k in kernels:
        t = launch_ts.get(k.get("args", {}).get("correlation"))
        if t is None:
            continue
        for name, ix in index.items():
            if _inside(ix, t):
                span_s[name] += k["dur"] * 1e-6
                span_launches[name] += 1
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    by_name = collections.Counter()
    for e in device:
        by_name[e["name"][:160]] += e["dur"] * 1e-6
    cpu = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events if e.get("cat") == "cpu_op")
    cpu_starts = [c[0] for c in cpu]
    gaps = collections.Counter()
    for (_, b), (a, _) in zip(merged, merged[1:]):
        label = "/".join(n for n in ("pass", "step", "gridattn", "unet", "vae_encode", "clip", "vae_decode")
                         if n in index and _inside(index[n], b)) or "outside"
        i = bisect.bisect_right(cpu_starts, b) - 1
        for j in range(i, max(i - 64, -1), -1):
            if cpu[j][1] >= b:
                label += ":" + cpu[j][2][:80]
                break
        gaps[label] += (a - b) * 1e-6
    return dict(
        busy_s=busy, kernels=len(kernels), span_s=dict(span_s), span_launches=dict(span_launches),
        span_calls={k: len(v) for k, v in spans.items()},
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(10)],
    )
