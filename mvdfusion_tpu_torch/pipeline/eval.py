"""Scene evaluation: prepare -> eta-DDIM -> chunked decode (counterpart of
mvdfusion_tpu/pipeline/eval.py::eval_scenes).

The JAX package vmaps the scene pipeline over a scene axis. Here the N
scenes of a call share one sampler pass (pipeline/sampler.py::
ddim_sample_scenes: one UNet call a step over their CFG batch of 2NB);
prepare_batch and the decode run once a scene. Scenes shard over ranks in
cli/demo.py.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import torch

from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion
from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample_scenes


class EvalOutput(NamedTuple):
    pred_rgb: torch.Tensor  # (N, B, H, W, 3) in [0, 1]
    gt_rgb: torch.Tensor  # (N, B, H, W, 3)
    pred_depth: torch.Tensor  # (N, B, h, w, 1) in [0, 1]
    gt_depth: torch.Tensor
    input_depth: torch.Tensor  # (N, 1, h, w, 1)


def _unnorm(d):
    return torch.clamp((d + 1.0) / 2.0, 0.0, 1.0)


@torch.no_grad()
def eval_scenes(
    model: ViewFusion,
    images: torch.Tensor,  # (N, S, H, W, 3)
    R: torch.Tensor,  # (N, S, 3, 3)
    T: torch.Tensor,
    f: torch.Tensor,
    c: torch.Tensor,
    input_idx: torch.Tensor,  # (1,) shared across scenes
    target_idx: torch.Tensor,  # (B,)
    cfg_scale: float,
    num_steps: int = 50,
    eta: float = 1.0,
    generators: Optional[Sequence[torch.Generator]] = None,  # one per scene
    init_noise: Optional[torch.Tensor] = None,  # (N, B, h, w, C)
    step_noise: Optional[torch.Tensor] = None,  # (N, S_steps, B, h, w, C)
    jitter_noise: Optional[torch.Tensor] = None,  # (N, S_steps, B, h, w, D)
    timings: Optional[list] = None,
) -> EvalOutput:
    """Generate the target views of N scenes in one sampler pass and decode
    them beside the ground truth. The noise comes from each scene's
    generator, drawn as a one-scene call draws it, or from the given arrays
    (so a test can feed the JAX chain the same noise). If `timings` is a
    list, the call appends its {prepare, sample, decode} seconds,
    synchronised on a CUDA device; without one it adds no synchronisation."""
    sync = torch.cuda.synchronize if images.is_cuda and timings is not None else (lambda: None)
    N = images.shape[0]
    sync()
    t0 = time.perf_counter()
    prepared = [model.prepare_batch(images[n], R[n], T[n], f[n], c[n], input_idx, target_idx) for n in range(N)]
    batch_latents, cams, in_lat, in_cams, clip_v = zip(*prepared)
    sync()
    t1 = time.perf_counter()
    res = ddim_sample_scenes(
        model, cams, in_lat, in_cams, torch.stack(clip_v), cfg_scale, num_steps=num_steps, eta=eta,
        feed_prev_depth=model.cfg.feed_prev_depth, init_noise=init_noise, step_noise=step_noise,
        jitter_noise=jitter_noise, generators=generators,
    )
    sync()
    t2 = time.perf_counter()
    batch_latents, in_lat = torch.stack(batch_latents), torch.stack(in_lat)
    # a scene's views are decoded together, in chunks of 8, as in a one-scene call
    decode = lambda z: torch.stack([model.decode_latents_chunked(z[n]) for n in range(N)])
    out = EvalOutput(
        pred_rgb=decode(res.latents[..., :4]),
        gt_rgb=decode(batch_latents[..., :4]),
        pred_depth=_unnorm(res.latents[..., 4:]),
        gt_depth=_unnorm(batch_latents[..., 4:]),
        input_depth=_unnorm(in_lat[..., 4:]),
    )
    sync()
    if timings is not None:
        timings.append(dict(prepare=t1 - t0, sample=t2 - t1, decode=time.perf_counter() - t2))
    return out
