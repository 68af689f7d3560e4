"""MVD-Fusion (arXiv 2404.03656; configs/mvd_gso.yaml), the architecture of
every configuration that names no "arch": the port's ViewFusion (the SD1
UNet with the ViewAligned sites, GridAttn, the VAE, CLIP ViT-L/14) against
portbench/reference.py. The contract each function keeps is in
portbench/README.md.

What `correct` compares, by name (OUTPUTS), each the worst view's RMS gap:

  rgb    pred_rgb: prepare (VAE encode, CLIP, cameras), every DDIM step
         (GridAttn, the UNet, the CFG mix, the update), the VAE decode
  depth  pred_depth: the same trajectory's depth channel, undecoded
  vae    gt_rgb, where the entry decodes the ground truth: the VAE's
         encode and decode alone

The frozen counts (`count`), each for one scene:

  unet          one step's UNet work for a scene: the conditional and the
                null halves, 2B views
  gridattn      one GridAttn call: one scene's B target views
  step          one sampler step for a scene: the time embedding, GridAttn,
                cc_projection, both UNet halves
  encode_image  the VAE encoder on one image
  clip_image    the CLIP tower on one image, with its preprocessing
  decode_view   the VAE decoder on one latent
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import counts, reference, traffic, weights

OUTPUTS = dict(rgb="pred_rgb", depth="pred_depth", vae="gt_rgb")
COUNTED = ("portbench/counts.py: torch.utils.flop_counter.FlopCounterMode over portbench/reference.py on the meta "
           "device at this file's shapes (a multiply-add is 2 operations); bytes are every parameter and every input "
           "and output tensor of the call once at 2 bytes an element. Per scene; bytes(N scenes) = param_bytes + N * "
           "act_bytes.")


# ------------------------------------------------------------ the program
def build(model_cfg: dict, state: dict, device):
    """The port's ViewFusion at the configuration's sizes, the seeded state
    loaded, cast to its compute types, in eval mode."""
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig

    fields = {f.name for f in dataclasses.fields(ViewFusionConfig)}
    unknown = sorted(set(model_cfg) - fields)
    if unknown:
        raise KeyError(f"configuration keys the program does not know: {unknown}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in model_cfg.items()}
    kw["dtype"] = getattr(torch, model_cfg["dtype"])
    model = ViewFusion(ViewFusionConfig(**kw), device=device)
    weights.load_program(model, state)
    return model.cast_for_inference().eval()


def reload(model, state: dict):
    """Another seed's weights into a built model (the control's runs)."""
    weights.load_program(model, state)
    return model.cast_for_inference()


def modules(model) -> dict:
    """The modules whose calls the benchmark's hooks mark, by span name; a
    step opens at GridAttn's call."""
    return dict(gridattn=model.view_attn, unet=model.unet, vae_encode=model.vae.encoder,
                vae_decode=model.vae.decoder, clip=model.clip_image_encoder, step=model.view_attn)


def views(inf: dict) -> int:
    return len(inf["targets"])


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


# ------------------------------------------------------ seed and traffic
def fan_in(name: str, shape: tuple) -> int:
    if name.endswith("visual.proj"):  # (width, output_dim), applied as x @ proj
        return shape[0]
    return weights.fan_in(name, shape)


def make_pass(model_cfg: dict, inf: dict, scenes: int, seed: int, index: int, device,
              purpose: int = weights.PASS) -> dict:
    """Pass `index` of a run: `scenes` scenes of `inf["views"]` random
    images in [0, 1], the rig, the input and target indices, and the
    sampler's noise: init (N, B, h, w, 5), step (N, S, B, h, w, 5) and
    jitter (N, S, B, h, w, D)."""
    s = weights.sub_seed(seed, purpose, index)
    rng = np.random.default_rng(s)
    g = torch.Generator(device=device).manual_seed(s)
    N, S, B = scenes, inf["views"], len(inf["targets"])
    H = inf["image_size"]
    ls, D, steps = model_cfg["latent_size"], model_cfg["n_pts_per_ray"], inf["steps"]
    C = model_cfg["unet_out_channels"]
    cams = [traffic.rig(inf, rng) for _ in range(N)]
    on = lambda a: torch.as_tensor(np.stack(a), device=device)
    randn = lambda *shape: torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return dict(
        images=torch.rand(N, S, H, H, 3, generator=g, device=device, dtype=torch.float32),
        R=on([c[0] for c in cams]), T=on([c[1] for c in cams]), f=on([c[2] for c in cams]), c=on([c[3] for c in cams]),
        input_idx=torch.tensor([inf["input"]], device=device),
        target_idx=torch.tensor(inf["targets"], device=device),
        init_noise=randn(N, B, ls, ls, C), step_noise=randn(N, steps, B, ls, ls, C),
        jitter_noise=randn(N, steps, B, ls, ls, D),
    )


# ------------------------------------------------------------ reference
def reference_class(model_cfg: dict):
    return reference.ViewFusion(model_cfg)


def reference_scene(ref, inf: dict, p: dict, n: int, decode_gt: bool) -> dict:
    """The reference's outputs for scene n of a pass's inputs `p`, in
    OUTPUTS' names."""
    prep = reference.prepare(ref, p["images"][n], p["R"][n], p["T"][n], p["f"][n], p["c"][n], p["input_idx"],
                             p["target_idx"])
    lat = reference.ddim_sample(ref, prep, p["init_noise"][n], p["step_noise"][n], p["jitter_noise"][n],
                                inf["cfg_scale"], inf["steps"], inf["eta"])
    # in chunks of 8 views, as the program's decode_latents_chunked, bounding the activations
    dec = lambda z: torch.cat([reference.decode(ref, c) for c in torch.split(z, 8)])
    out = dict(pred_rgb=dec(lat[..., :4]), pred_depth=_depth(lat))
    if decode_gt:
        out["gt_rgb"] = dec(prep.batch_latents.permute(0, 2, 3, 1)[..., :4])
    return out


# ---------------------------------------------------------------- counts
def count(config: dict) -> dict:
    m, inf = config["model"], config["inference"]
    with torch.device("meta"), torch.no_grad():
        ref = reference.ViewFusion(m)
        S, B, H, ls = inf["views"], len(inf["targets"]), inf["image_size"], m["latent_size"]
        D, ctx = m["n_pts_per_ray"], m["context_dim"]
        eye = torch.eye(3).expand(S, 3, 3)
        T = torch.zeros(S, 3)
        f, c = torch.ones(S, 2), torch.zeros(S, 2)
        images = torch.zeros(S, H, H, 3)
        idx_in, idx_t = torch.zeros(1, dtype=torch.long), torch.arange(1, B + 1)
        p = reference.prepare(ref, images, eye, T, f, c, idx_in, idx_t)
        x = torch.zeros(B, m["unet_out_channels"], ls, ls)
        t = torch.zeros(B, dtype=torch.long)
        jitter = torch.zeros(B, D, ls, ls)
        tables = reference.ddpm_tables(m, "meta")
        t_embed = torch.zeros(B, m["time_embed_dim"])
        x_in = torch.zeros(2 * B, m["unet_in_channels"], ls, ls)
        t2 = torch.zeros(2 * B, dtype=torch.long)
        ctx_in = torch.zeros(2 * B, 1, ctx)
        levels = {ls >> i: torch.zeros(2 * B, ls >> i, ls >> i, D, ctx) for i in range(len(m["unet_channel_mult"]))}
        unet_out = torch.zeros(2 * B, m["unet_out_channels"], ls, ls)
        frustum = torch.zeros(B, ls, ls, D, ctx)
        vae, clip = ref.vae, ref.clip_image_encoder.model.visual
        img1, lat1 = torch.zeros(1, H, H, 3), torch.zeros(1, ls, ls, m["vae_embed_dim"])
        flops, numel, params, BYTES = counts.flops, counts.numel, counts.params, counts.BYTES
        return dict(
            unet=dict(flops=flops(lambda: ref.unet(x_in, t2, ctx_in, levels)), param_bytes=BYTES * params(ref.unet),
                      act_bytes=BYTES * numel(x_in, t2, ctx_in, levels, unet_out)),
            gridattn=dict(flops=flops(lambda: ref.view_attn(x, p.cams, t_embed, t, tables[1], tables[2], p.in_lat,
                                                            p.in_cams, jitter)),
                          param_bytes=BYTES * params(ref.view_attn),
                          act_bytes=BYTES * numel(x, p.cams, t_embed, p.in_lat, p.in_cams, jitter, frustum)),
            step=dict(flops=flops(lambda: reference.apply_model_cfg(ref, p, x, t, jitter, inf["cfg_scale"], tables))),
            encode_image=dict(flops=flops(lambda: reference.encode(ref, img1)), param_bytes=BYTES * params(vae.encoder),
                              act_bytes=BYTES * numel(img1, lat1)),
            clip_image=dict(flops=flops(lambda: clip(reference.clip_preprocess(img1))),
                            param_bytes=BYTES * params(clip), act_bytes=BYTES * (numel(img1) + ctx)),
            decode_view=dict(flops=flops(lambda: reference.decode(ref, lat1)), param_bytes=BYTES * params(vae.decoder),
                             act_bytes=BYTES * numel(img1, lat1)),
        )


def pass_flops(cell) -> float:
    """The semantic operations of one pass of the cell's traffic: for each
    scene, prepare (the VAE encoder on the input and target images, CLIP
    on the input), every sampler step, and the decodes (the targets, and
    the ground truth where the entry decodes it)."""
    c, inf = cell.config["counts"], cell.config["inference"]
    B = len(inf["targets"])
    decodes = B * (2 if cell.traffic["decodes_ground_truth"] else 1)
    scene = ((1 + B) * c["encode_image"]["flops"] + c["clip_image"]["flops"] + inf["steps"] * c["step"]["flops"]
             + decodes * c["decode_view"]["flops"])
    return cell.traffic["scenes_per_pass"] * scene
