"""The port's spans and step marks: one bounded ring of records that the
sampler and the model append to as they run, read after the fact.

`span(name)` records, on every call, its name, its host start and end
(`time.perf_counter_ns`), the sampler pass it ran in (the id that a span
opened with `opens_pass` gives every span inside it; None outside one), its
parent span, the step index where there is one, and whether a
torch.profiler session was running. While one runs, the span also opens
`record_function("mvdf." + name)`, which places it in the profiler's trace
beside the kernels launched inside it; with none running, no
record_function is made.

A span given `step=` is a step. It stores the increase of the port's own
kernel launches over it (the sum of ops/_lib.py's LAUNCHES, read, never
copied; a replayed CUDA graph launches none from the host), and on a CUDA
`device` it records one CUDA event on the current stream at each step
boundary (a step's end is the next step's start in the same pass). The
events are never synchronised inside the pass: `Record.device_ms` reads
them after it.

The spans of the port, one record each call:

    sample.pass      pipeline/sampler.py::ddim_sample_scenes or
                     ddim_sample_views, opens the pass
    sample.step      each step of its loop (the model, ddim_step, the clamp)
    model.gridattn   nn/viewfusion.py::_frustum's GridAttn call, N a step
    gridattn.capture inside model.gridattn: nn/viewattn.py::GridAttn.forward
                     captured its CUDA graph (the first call of a key)
    gridattn.replay  inside model.gridattn: it replayed one
    model.unet       nn/viewfusion.py::_unet's UNet call, or
                     nn/mvdream.py::MVDream.apply_model_cfg's, 1 a step
    model.mvattn     inside model.unet: a self-attention over a group's
                     views joined (nn/unet.py::BasicTransformerBlock with
                     num_frames > 1), one a site: 16 a step in MVDream
    model.text       nn/mvdream.py::MVDream.encode_text's text tower call

Training reaches the two model spans too, outside any pass and step. The
ring keeps the last RING records; spans nest on the thread that runs the
sampler.
"""

from __future__ import annotations

import collections
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

from mvdfusion_tpu_torch.ops import _lib

RING = 65536
PREFIX = "mvdf."

_ring: collections.deque = collections.deque(maxlen=RING)
_open: list = []  # the spans open now, innermost last
_ids = itertools.count(1)
_pass_ids = itertools.count(1)
_boundary = [None, None]  # (pass id, CUDA event) at the end of the last step


class Record:
    """One span's call. `end_ns` is None while it is open; `launches` and
    the events are set on steps only."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "pass_id", "parent", "step", "profiled", "launches",
                 "start_event", "end_event")

    @property
    def host_ms(self):
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self):
        """The stream's milliseconds between the step's boundary events
        (waits for the end event); None off a CUDA device or while open."""
        if self.end_event is None:
            return None
        self.end_event.synchronize()
        return self.start_event.elapsed_time(self.end_event)


def _event(device):
    e = torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(device))
    return e


class span:
    """`with span(name):` records the call (module docstring). `step`: the
    step index, which makes the span a step; `device` (a torch.device):
    where the step's boundary events go (CUDA only); `opens_pass`: the span
    starts a sampler pass."""

    __slots__ = ("name", "step", "device", "opens_pass", "rec", "rf")

    def __init__(self, name: str, step: int | None = None, device=None, opens_pass: bool = False):
        self.name, self.step, self.device, self.opens_pass = name, step, device, opens_pass

    def __enter__(self):
        parent = _open[-1] if _open else None
        r = Record()
        r.id, r.name, r.parent = next(_ids), self.name, parent.id if parent else None
        r.pass_id = next(_pass_ids) if self.opens_pass else (parent.pass_id if parent else None)
        r.step = self.step if self.step is not None else (parent.step if parent else None)
        r.profiled = _profiler._is_profiler_enabled
        r.end_ns = r.launches = r.start_event = r.end_event = None
        self.rf = None
        if r.profiled:
            self.rf = _profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if self.step is not None:
            if getattr(self.device, "type", None) == "cuda":
                shared = r.pass_id is not None and _boundary[0] == r.pass_id
                r.start_event = _boundary[1] if shared else _event(self.device)
            r.launches = sum(_lib.LAUNCHES.values())
        _open.append(r)
        _ring.append(r)
        self.rec = r
        r.start_ns = time.perf_counter_ns()
        return r

    def __exit__(self, *exc):
        r = self.rec
        r.end_ns = time.perf_counter_ns()
        if self.step is not None:
            r.launches = sum(_lib.LAUNCHES.values()) - r.launches
            if r.start_event is not None:
                r.end_event = _event(self.device)
                _boundary[:] = [r.pass_id, r.end_event]
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _open.remove(r)
        return False


def records() -> list:
    """The ring's records, oldest first (a record is appended as its span
    opens)."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
    _boundary[:] = [None, None]
