"""The comparison that decides `correct`: the program's served outputs of
a sample of the window's scenes against the plain reference run on the same
weights, inputs and noise.

For each sampled scene the architecture's reference (its `reference_class`
and `reference_scene`, portbench/archs/<arch>.py) serves it as the entry
does, in float32 without TF32, and each output that the architecture's
OUTPUTS names is compared view by view: the root-mean-square gap of a view
over its pixels and channels, the worst view of the worst sampled scene.
The control is that reference with its products in float8
(`precision.fake_quantize_`: every Linear and Conv2d, and each product the
reference's own modules round by their `fake_quantize_`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import precision, weights


def sample_scenes(cell, seed: int, passes: int) -> list:
    """The (pass, slot) pairs a run with `passes` completed passes compares:
    `sample.scenes` of them, drawn from the seed, each in a slot of the pass
    that no other pick has where the pass has slots enough, so that a fault
    in one slot of a batched pass shows in as many runs as it can."""
    N = cell.traffic["scenes_per_pass"]
    k = min(cell.spec["sample"]["scenes"], passes * N)
    rng = np.random.default_rng(weights.sub_seed(seed, weights.SAMPLE))
    if k <= N:
        picks = [(int(rng.integers(passes)), int(n)) for n in rng.choice(N, size=k, replace=False)]
    else:
        picks = [divmod(int(i), N) for i in rng.choice(passes * N, size=k, replace=False)]
    return sorted(picks)


def reference_model(arch, m: dict, state: dict, device, fp8: bool = False):
    with torch.device("meta"):
        ref = arch.reference_class(m)
    ref = ref.to_empty(device=device)
    weights.load_reference(ref, state)
    if fp8:
        precision.fake_quantize_(ref)
    return ref.eval()


def view_rms(a, b):
    """(B, ...) -> the largest per-view RMS of a - b."""
    d = (a.float() - b.float()).reshape(a.shape[0], -1)
    return float(torch.sqrt((d * d).mean(dim=1)).max())


@torch.no_grad()
def reference_scene(arch, ref, inf: dict, p: dict, n: int, decode_gt: bool) -> dict:
    """The reference's outputs for scene n of a pass's inputs `p`, its
    products in true float32."""
    with precision.float32_products():
        return arch.reference_scene(ref, inf, p, n, decode_gt)


def gaps(arch, got: dict, want: dict) -> dict:
    """{name: worst view's RMS gap} for the outputs both sides have; `got`
    holds one scene's outputs (B, ...)."""
    return {k: view_rms(got[v], want[v]) for k, v in arch.OUTPUTS.items() if v in got and v in want}


def worst(readings: list) -> dict:
    """The largest reading of each number over the sampled scenes."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited number at or below
    its limit and finite; a number the run did not produce fails."""
    rows, ok = [], True
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        ok = ok and v == v and v <= lim
        rows.append((k, v, lim))
    return ok, rows
