"""One call captured into a CUDA graph and replayed.

`Graphed(fn, inputs)` copies `inputs` into static tensors of its own, runs
fn on them once on a side stream (the warm-up: every lazy allocation,
prepared weight, tensor map and library handle is made there, outside the
capture), captures one more call of fn on that stream into a
torch.cuda.CUDAGraph with a memory pool of its own, and stops. A call then
copies its inputs into the static tensors, replays the graph on the current
stream and returns a copy of the graph's output, so that the next replay
cannot overwrite what a caller still holds. Capturing synchronises nothing.

fn must issue the same work for any values of inputs of these shapes:
every Python-level choice it makes is fixed at the capture, and any tensor
it reads other than its inputs is read where it lay then. The caller keys
its graphs on those choices and holds those tensors on the graph's `keep`
while it lives. A graph launches its kernels without the host: the warm-up
and the capture count nothing in ops/_lib.py's counters, and each replay
adds what the capture counted to `_lib.REPLAYED`.
"""

from __future__ import annotations

import torch

from mvdfusion_tpu_torch.ops import _lib


class Graphed:
    """fn(*inputs) captured once (module docstring); inputs are tensors or
    None (passed to fn as None on every call)."""

    def __init__(self, fn, inputs):
        self.inputs = [None if x is None else x.clone() for x in inputs]
        self.keep = ()  # what else the graph reads, set by the caller
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(main.device)
        side.wait_stream(main)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            with _lib.uncounted():
                fn(*self.inputs)
            with _lib.uncounted() as self.counts:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.output = fn(*self.inputs)
                finally:
                    self.graph.capture_end()
        main.wait_stream(side)

    def __call__(self, inputs) -> torch.Tensor:
        pairs = [(s, x) for s, x in zip(self.inputs, inputs) if s is not None]
        torch._foreach_copy_([s for s, _ in pairs], [x for _, x in pairs])
        self.graph.replay()
        _lib.count_replay(self.counts)
        return self.output.clone()
