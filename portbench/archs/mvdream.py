"""MVDream (arXiv 2308.16512; github.com/bytedance/MVDream,
mvdream/configs/sd-v2-base.yaml), text to four views: the port's MVDream
(nn/mvdream.py: SD-2.1-base's UNet with the views joined in every
self-attention and a camera embedding, OpenCLIP ViT-H/14's text tower, the
SD VAE decoder) against portbench/reference_mvdream.py. The contract each
function keeps is in portbench/README.md.

What `correct` compares, by name (OUTPUTS), each the worst view's RMS gap:

  rgb     pred_rgb: the text tower, every DDIM step (the CFG UNet call, the
          mix, the update), the VAE decode
  latent  pred_latent: the same trajectory's final latents, undecoded

The frozen counts (`count`), each for one request (scene):

  unet         one step's UNet call for a request: both CFG halves, 2F views
  mvattn       one step's joined self-attentions of a request (attn1 of the
               16 sites with its projections, both CFG halves)
  text         the text tower on one prompt
  decode_view  the VAE decoder (post_quant_conv included) on one latent

The modules the hooks mark (`modules`): `step` and `unet` the UNet, whose
call opens each sampler step; `vae_decode` the VAE's decoding half;
`text` the text tower; `mvattn.0` ... `mvattn.15` the 16 sites' joined
attn1. Its own metrics, each listing its cells: mvattn_ms (the mvattn.<i>
spans' device ms a step), mvattn_roofline (the mvattn counts' bound over
that time) and host_mvattn_ms (the program's `model.mvattn` spans, host
ms a step).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import counts, reference_mvdream as reference, weights

OUTPUTS = dict(rgb="pred_rgb", latent="pred_latent")
COUNTED = ("portbench/counts.py: torch.utils.flop_counter.FlopCounterMode over portbench/reference_mvdream.py on the "
           "meta device at this file's shapes (a multiply-add is 2 operations); bytes are every parameter and every "
           "input and output tensor of the call once at 2 bytes an element. Per request; bytes(N requests) = "
           "param_bytes + N * act_bytes.")


# ------------------------------------------------------------ the program
def build(model_cfg: dict, state: dict, device):
    """The port's MVDream at the configuration's sizes, the seeded state
    loaded, cast to its compute types, in eval mode."""
    from mvdfusion_tpu_torch.core.config import MVDreamConfig
    from mvdfusion_tpu_torch.nn.mvdream import MVDream

    fields = {f.name for f in dataclasses.fields(MVDreamConfig)}
    unknown = sorted(set(model_cfg) - fields)
    if unknown:
        raise KeyError(f"configuration keys the program does not know: {unknown}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()}
    kw["dtype"] = getattr(torch, model_cfg["dtype"])
    model = MVDream(MVDreamConfig(**kw), device=device)
    weights.load_program(model, state)
    return model.cast_for_inference().eval()


def reload(model, state: dict):
    """Another seed's weights into a built model (the control's runs)."""
    weights.load_program(model, state)
    return model.cast_for_inference()


def modules(model) -> dict:
    """The modules whose calls the benchmark's hooks mark, by span name: a
    step opens at the UNet's call; mvattn.<i> is the joined attn1 of site i
    in call order (input, middle, output blocks)."""
    from mvdfusion_tpu_torch.nn.unet import BasicTransformerBlock

    sites = [b for b in model.unet.modules() if isinstance(b, BasicTransformerBlock) and b.num_frames > 1]
    joined = {f"mvattn.{i}": b.attn1 for i, b in enumerate(sites)}
    return dict(unet=model.unet, step=model.unet, vae_decode=model.first_stage_model, text=model.cond_stage_model,
                **joined)


def views(inf: dict) -> int:
    return inf["views"]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cameras(inf: dict, azimuths, device):
    from mvdfusion_tpu_torch.nn.mvdream import get_camera

    cams = [get_camera(inf["views"], inf["elevation_deg"], float(a), inf["azimuth_span_deg"]) for a in azimuths]
    return torch.stack(cams).to(device)


@torch.no_grad()
def t2mv(model, p: dict, inf: dict, timings: list) -> dict:
    """MVDream's t2i.py for each of the pass's N requests: the text tower on
    the empty prompt and the N prompts in one call and each request's rig
    (prepare), one pipeline/sampler.py::ddim_sample_views pass over all N
    (sample), MVDream.decode_latents for each request's views (decode)."""
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample_views

    dev = p["tokens"].device
    N = p["tokens"].shape[0]
    _sync(dev)
    t0 = time.perf_counter()
    ctx = model.encode_text(torch.cat([p["null_tokens"], p["tokens"]]))
    cam = _cameras(inf, p["azimuth"], dev)
    _sync(dev)
    t1 = time.perf_counter()
    res = ddim_sample_views(model, ctx[1:], ctx[:1], cam, inf["cfg_scale"], num_steps=inf["steps"],
                            init_noise=p["init_noise"])
    _sync(dev)
    t2 = time.perf_counter()
    rgb = torch.stack([model.decode_latents(res.latents[n]) for n in range(N)])
    _sync(dev)
    timings.append(dict(prepare=t1 - t0, sample=t2 - t1, decode=time.perf_counter() - t2))
    return dict(pred_rgb=rgb, pred_latent=res.latents)


ENTRIES = dict(t2mv=t2mv)


# ------------------------------------------------------ seed and traffic
def make_pass(model_cfg: dict, inf: dict, scenes: int, seed: int, index: int, device,
              purpose: int = weights.PASS) -> dict:
    """Pass `index` of a run: `scenes` prompts of token ids (BOS, then
    inf["prompt_tokens"] ids below BOS, the count drawn per prompt, EOS,
    zeros to the context length), the empty prompt (BOS, EOS, zeros), each
    request's azimuth start in [0, 360) and its initial latents
    (N, F, h, w, C). BOS and EOS are the vocabulary's last two ids
    (49406, 49407 in OpenCLIP's)."""
    if inf["image_size"] != 8 * model_cfg["image_size"] or inf["eta"] != 0:
        raise ValueError("MVDream's sampler runs at eta 0, its images 8 x the latent's side")
    s = weights.sub_seed(seed, purpose, index)
    rng = np.random.default_rng(s)
    g = torch.Generator(device=device).manual_seed(s)
    N, F, h, C = scenes, inf["views"], model_cfg["image_size"], model_cfg["out_channels"]
    L, V = model_cfg["text_context_length"], model_cfg["text_vocab_size"]
    bos, eos = V - 2, V - 1
    lo, hi = inf["prompt_tokens"]
    n_ids = torch.as_tensor(rng.integers(lo, hi + 1, N), device=device)[:, None]
    ids = torch.randint(0, bos, (N, L), generator=g, device=device)
    pos = torch.arange(L, device=device)
    tokens = torch.where(pos <= n_ids, ids, torch.where(pos == n_ids + 1, eos, 0))
    tokens[:, 0] = bos
    null = torch.zeros(1, L, dtype=torch.long, device=device)
    null[0, :2] = torch.tensor([bos, eos], device=device)
    return dict(tokens=tokens, null_tokens=null, azimuth=rng.uniform(0.0, 360.0, N),
                init_noise=torch.randn(N, F, h, h, C, generator=g, device=device, dtype=torch.float32))


# ------------------------------------------------------------ reference
def reference_class(model_cfg: dict):
    return reference.MVDream(model_cfg)


def reference_scene(ref, inf: dict, p: dict, n: int, decode_gt: bool) -> dict:
    """The reference's outputs for request n of a pass's inputs `p`, in
    OUTPUTS' names."""
    dev = p["tokens"].device
    ctx = reference.encode_text(ref, p["tokens"][n: n + 1])
    uc = reference.encode_text(ref, p["null_tokens"])
    cam = reference.get_camera(inf["views"], inf["elevation_deg"], float(p["azimuth"][n]), inf["azimuth_span_deg"])
    lat = reference.ddim_sample(ref, ctx, uc, cam.to(dev), p["init_noise"][n], inf["cfg_scale"], inf["steps"])
    return dict(pred_rgb=reference.decode(ref, lat), pred_latent=lat)


# ---------------------------------------------------------------- counts
def count(config: dict) -> dict:
    m, inf = config["model"], config["inference"]
    with torch.device("meta"), torch.no_grad():
        ref = reference.MVDream(m)
        B, h, L = 2 * inf["views"], m["image_size"], m["text_context_length"]
        x, t = torch.zeros(B, m["in_channels"], h, h), torch.zeros(B, dtype=torch.long)
        ctx, cam = torch.zeros(B, L, m["context_dim"]), torch.zeros(B, m["camera_dim"])
        out = torch.zeros(B, m["out_channels"], h, h)
        shapes = []
        joined = [blk.attn1 for blk in ref.unet.modules() if isinstance(blk, reference.BasicTransformerBlock3D)]
        hooks = [a.register_forward_pre_hook(lambda _m, args: shapes.append(tuple(args[0].shape))) for a in joined]
        ref.unet(x, t, ctx, cam)
        for hk in hooks:
            hk.remove()
        attn_in = [torch.zeros(s) for s in shapes]
        tok = torch.zeros(1, L, dtype=torch.long)
        lat1 = torch.zeros(1, h, h, m["vae_embed_dim"])
        img1 = torch.zeros(1, 8 * h, 8 * h, 3)
        text = ref.cond_stage_model.model
        flops, numel, params, BYTES = counts.flops, counts.numel, counts.params, counts.BYTES
        return dict(
            unet=dict(flops=flops(lambda: ref.unet(x, t, ctx, cam)), param_bytes=BYTES * params(ref.unet),
                      act_bytes=BYTES * numel(x, t, ctx, cam, out)),
            mvattn=dict(flops=flops(lambda: [a(z) for a, z in zip(joined, attn_in)]),
                        param_bytes=BYTES * sum(params(a) for a in joined), act_bytes=BYTES * 2 * numel(attn_in)),
            text=dict(flops=flops(lambda: text(tok)), param_bytes=BYTES * params(text),
                      act_bytes=BYTES * (numel(tok) + L * m["text_width"])),
            decode_view=dict(flops=flops(lambda: reference.decode(ref, lat1)),
                             param_bytes=BYTES * params(ref.first_stage_model), act_bytes=BYTES * numel(img1, lat1)),
        )


def pass_flops(cell) -> float:
    """The semantic operations of one pass of the cell's traffic: the text
    tower on each prompt and on the empty one, every step's UNet call for
    each request, and the decode of every view."""
    c, inf = cell.config["counts"], cell.config["inference"]
    N = cell.traffic["scenes_per_pass"]
    return ((N + 1) * c["text"]["flops"] + N * inf["steps"] * c["unet"]["flops"]
            + N * inf["views"] * c["decode_view"]["flops"])
