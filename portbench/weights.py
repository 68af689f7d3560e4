"""Seeded weights and inputs, made on the device from one seed.

`make_state` draws one state dict in the names of the architecture's
reference (its `reference_class`) from a torch.Generator on the device, in
a few large draws, every value rounded to bfloat16 (the type the towers are
served in) so that the program and the reference read the same numbers.
`load_program` puts it into the program's model; the reference loads it
with `load_state_dict` as it stands. An architecture may give its own
`fan_in` where the default does not fit it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

CHUNK = 1 << 27  # elements a draw


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose of a run's seed (weights, a pass's
    inputs, the sample), independent across purposes."""
    return int(np.random.SeedSequence([seed % (1 << 64), *path]).generate_state(1, np.uint64)[0] >> 1)


WEIGHTS, PASS, SAMPLE, WARMUP, TRACE = 1, 2, 3, 4, 5


def norm_scale_names(model: nn.Module) -> set:
    """State-dict names of the GroupNorm and LayerNorm scales."""
    return {f"{n}.weight" for n, mod in model.named_modules()
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) and mod.weight is not None}


def fan_in(name: str, shape: tuple) -> int:
    return int(np.prod(shape[1:]))


def state_spec(arch, m: dict) -> list:
    """[(name, shape, kind)] of the reference layout, kind "norm" (scale
    1 + N(0, 0.1^2)), "matrix" (N(0, 1 / fan_in)) or "small" (N(0, 0.02^2))."""
    with torch.device("meta"):
        ref = arch.reference_class(m)
    norms = norm_scale_names(ref)
    spec = []
    for name, p in ref.state_dict().items():
        if name in norms:
            kind = "norm"
        elif p.ndim >= 2 and "embedding" not in name:
            kind = "matrix"
        else:
            kind = "small"
        spec.append((name, tuple(p.shape), kind))
    return spec


def make_state(arch, m: dict, seed: int, device) -> dict:
    """The seeded state dict of the architecture `arch` at the model
    configuration `m`, bfloat16 tensors on `device`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    spec = state_spec(arch, m)
    fan = getattr(arch, "fan_in", fan_in)
    state, i = {}, 0
    while i < len(spec):
        j, n = i, 0
        while j < len(spec) and (n == 0 or n + int(np.prod(spec[j][1])) <= CHUNK):
            n += int(np.prod(spec[j][1]))
            j += 1
        buf = torch.randn(n, generator=g, device=device, dtype=torch.float32)
        off = 0
        for name, shape, kind in spec[i:j]:
            k = int(np.prod(shape))
            r = buf[off: off + k].view(shape)
            off += k
            if kind == "norm":
                v = 1.0 + 0.1 * r
            elif kind == "matrix":
                v = r / fan(name, shape) ** 0.5
            else:
                v = 0.02 * r
            state[name] = v.to(torch.bfloat16)
        del buf
        i = j
    return state


def load_program(model, state: dict) -> None:
    """Copy the state into the program's model, every key matched both
    ways; the model casts to its own compute types afterwards."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: the program has {missing[:5]} unmatched, the seed's {extra[:5]}")
    with torch.no_grad():
        for name, t in own.items():
            if tuple(t.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: program {tuple(t.shape)}, seed {tuple(state[name].shape)}")
            t.copy_(state[name])


def load_reference(ref, state: dict) -> None:
    ref.load_state_dict(state, strict=True)  # copy_ widens bfloat16 to float32 exactly
