"""The system under test: the port's model built from a configuration, and
the entries a traffic file can name. This is the only module of the
benchmark that imports the port (mvdfusion_tpu_torch), and only inside its
functions.

An entry takes (model, a pass's inputs, the configuration's inference
section, a list for its timings), serves the pass's scenes, appends the
synchronised seconds of its prepare, sample and decode phases, and returns
what the user gets: pred_rgb (N, B, H, W, 3) and pred_depth (N, B, h, w, 1)
in [0, 1], and gt_rgb where it decodes the ground truth too.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def build_kernels(device) -> float:
    """The port's CUDA kernels built, where they are not yet (a checkout's
    first run); the seconds that took, 0 where nothing was built."""
    if torch.device(device).type != "cuda":
        return 0.0
    from mvdfusion_tpu_torch.ops import _lib

    info = _lib.build()
    return info["seconds"] if info["built"] else 0.0


def build(model_cfg: dict, state: dict, device):
    """The port's ViewFusion at the configuration's sizes, the seeded state
    loaded, cast to its compute types, in eval mode."""
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig

    from portbench.weights import load_program

    fields = {f.name for f in dataclasses.fields(ViewFusionConfig)}
    unknown = sorted(set(model_cfg) - fields)
    if unknown:
        raise KeyError(f"configuration keys the program does not know: {unknown}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()}
    kw["dtype"] = getattr(torch, model_cfg["dtype"])
    model = ViewFusion(ViewFusionConfig(**kw), device=device)
    load_program(model, state)
    return model.cast_for_inference().eval()


def reload(model, state: dict):
    """Another seed's weights into a built model (the control's runs)."""
    from portbench.weights import load_program

    load_program(model, state)
    return model.cast_for_inference()


def modules(model) -> dict:
    """The modules whose calls the benchmark's hooks mark, by span name."""
    return dict(gridattn=model.view_attn, unet=model.unet, vae_encode=model.vae.encoder,
                vae_decode=model.vae.decoder, clip=model.clip_image_encoder)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _depth(latents):
    return torch.clamp((latents[..., 4:] + 1.0) / 2.0, 0.0, 1.0)


@torch.no_grad()
def eval_scenes(model, p: dict, inf: dict, timings: list) -> dict:
    """pipeline/eval.py::eval_scenes over the pass's N scenes."""
    from mvdfusion_tpu_torch.pipeline.eval import eval_scenes as run

    out = run(model, p["images"], p["R"], p["T"], p["f"], p["c"], p["input_idx"], p["target_idx"], inf["cfg_scale"],
              num_steps=inf["steps"], eta=inf["eta"], init_noise=p["init_noise"], step_noise=p["step_noise"],
              jitter_noise=p["jitter_noise"], timings=timings)
    return dict(pred_rgb=out.pred_rgb, pred_depth=out.pred_depth, gt_rgb=out.gt_rgb)


@torch.no_grad()
def requests(model, p: dict, inf: dict, timings: list) -> dict:
    """The flagship request for each of the pass's N scenes:
    ViewFusion.prepare_batch for each, one pipeline/sampler.py::
    ddim_sample_scenes pass over all N, ViewFusion.decode_latents for
    each."""
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample_scenes

    dev = p["images"].device
    N = p["images"].shape[0]
    _sync(dev)
    t0 = time.perf_counter()
    prepared = [model.prepare_batch(p["images"][n], p["R"][n], p["T"][n], p["f"][n], p["c"][n], p["input_idx"],
                                    p["target_idx"]) for n in range(N)]
    _, cams, in_lat, in_cams, clip_v = zip(*prepared)
    _sync(dev)
    t1 = time.perf_counter()
    res = ddim_sample_scenes(model, cams, in_lat, in_cams, torch.stack(clip_v), inf["cfg_scale"],
                             num_steps=inf["steps"], eta=inf["eta"], feed_prev_depth=model.cfg.feed_prev_depth,
                             init_noise=p["init_noise"], step_noise=p["step_noise"], jitter_noise=p["jitter_noise"])
    _sync(dev)
    t2 = time.perf_counter()
    rgb = torch.stack([model.decode_latents(res.latents[n][..., :4]) for n in range(N)])
    _sync(dev)
    timings.append(dict(prepare=t1 - t0, sample=t2 - t1, decode=time.perf_counter() - t2))
    return dict(pred_rgb=rgb, pred_depth=_depth(res.latents))


ENTRIES = dict(eval_scenes=eval_scenes, requests=requests)
