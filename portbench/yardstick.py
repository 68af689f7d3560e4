"""The peaks of the card and the arithmetic on the frozen counts.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit
(bf16 tensor-core operations and HBM3 bandwidth), the figures of
chip_smoke.py's `bound`.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes at peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def counts(cell) -> dict:
    return cell.config["counts"]


def call_bound_s(cell, what: str, scenes: int, calls: int = 1) -> float:
    """The bound of `calls` calls of a counted part over `scenes` scenes
    each: operations scale with the scenes, parameters are read once a
    call."""
    c = counts(cell)[what]
    return calls * bound_s(scenes * c["flops"], c["param_bytes"] + scenes * c["act_bytes"])


def pass_flops(cell) -> float:
    """The semantic operations of one pass of the cell's traffic: for each
    scene, prepare (the VAE encoder on the input and target images, CLIP
    on the input), every sampler step, and the decodes (the targets, and
    the ground truth where the entry decodes it)."""
    c, inf = counts(cell), cell.config["inference"]
    B = len(inf["targets"])
    decodes = B * (2 if cell.traffic["decodes_ground_truth"] else 1)
    scene = ((1 + B) * c["encode_image"]["flops"] + c["clip_image"]["flops"] + inf["steps"] * c["step"]["flops"]
             + decodes * c["decode_view"]["flops"])
    return cell.traffic["scenes_per_pass"] * scene
