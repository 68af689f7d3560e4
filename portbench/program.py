"""The set-up every architecture of the port shares: its CUDA kernels built.
The port (mvdfusion_tpu_torch) is imported here and in portbench/archs/,
and only inside functions; each architecture's model, entries and spans
are in its file there.

An entry takes (model, a pass's inputs, the configuration's inference
section, a list for its timings), serves the pass's scenes, appends the
synchronised seconds of its prepare, sample and decode phases, and returns
what the user gets, under the names of its architecture's OUTPUTS.
"""

from __future__ import annotations

import torch


def build_kernels(device) -> float:
    """The port's CUDA kernels built, where they are not yet (a checkout's
    first run); the seconds that took, 0 where nothing was built."""
    if torch.device(device).type != "cuda":
        return 0.0
    from mvdfusion_tpu_torch.ops import _lib

    info = _lib.build()
    return info["seconds"] if info["built"] else 0.0
