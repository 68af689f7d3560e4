"""The comparison that decides `correct`: the program's served outputs of
a sample of the window's scenes against the plain reference run on the same
weights, images, cameras and noise.

For each sampled scene the reference prepares, samples and decodes as the
entry does (portbench/reference.py), in float32 without TF32, and each
output is compared view by view: the root-mean-square gap of a view over
its pixels and channels, the worst view of the worst sampled scene. The
names and what each covers:

  rgb    pred_rgb: prepare (VAE encode, CLIP, cameras), every DDIM step
         (GridAttn, the UNet, the CFG mix, the update), the VAE decode
  depth  pred_depth: the same trajectory's depth channel, undecoded
  vae    gt_rgb, where the entry decodes the ground truth: the VAE's
         encode and decode alone
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference, weights

OUTPUTS = dict(rgb="pred_rgb", depth="pred_depth", vae="gt_rgb")


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


def reference_model(m: dict, state: dict, device, fp8: bool = False):
    with torch.device("meta"):
        ref = reference.ViewFusion(m)
    ref = ref.to_empty(device=device)
    weights.load_reference(ref, state)
    if fp8:
        reference.fake_quantize_(ref)
    return ref.eval()


def view_rms(a, b):
    """(B, ...) -> the largest per-view RMS of a - b."""
    d = (a.float() - b.float()).reshape(a.shape[0], -1)
    return float(torch.sqrt((d * d).mean(dim=1)).max())


@torch.no_grad()
def reference_scene(ref, inf: dict, p: dict, n: int, decode_gt: bool) -> dict:
    """The reference's outputs for scene n of a pass's inputs `p`, its
    products in true float32."""
    with reference.float32_products():
        return _reference_scene(ref, inf, p, n, decode_gt)


def _reference_scene(ref, inf, p, n, decode_gt):
    prep = reference.prepare(ref, p["images"][n], p["R"][n], p["T"][n], p["f"][n], p["c"][n], p["input_idx"],
                             p["target_idx"])
    lat = reference.ddim_sample(ref, prep, p["init_noise"][n], p["step_noise"][n], p["jitter_noise"][n],
                                inf["cfg_scale"], inf["steps"], inf["eta"])
    # in chunks of 8 views, as the program's decode_latents_chunked, bounding the activations
    dec = lambda z: torch.cat([reference.decode(ref, c) for c in torch.split(z, 8)])
    out = dict(pred_rgb=dec(lat[..., :4]), pred_depth=torch.clamp((lat[..., 4:] + 1.0) / 2.0, 0.0, 1.0))
    if decode_gt:
        out["gt_rgb"] = dec(prep.batch_latents.permute(0, 2, 3, 1)[..., :4])
    return out


def gaps(got: dict, want: dict) -> dict:
    """{name: worst view's RMS gap} for the outputs both sides have; `got`
    holds one scene's outputs (B, ...)."""
    return {k: view_rms(got[v], want[v]) for k, v in OUTPUTS.items() if v in got and v in want}


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
