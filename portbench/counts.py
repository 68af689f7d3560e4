"""The frozen work counts of a configuration, taken once from its shapes on
the benchmark's own reference (portbench/reference.py) on the meta device,
and written into the configuration's file under "counts":

    python -m portbench.counts portbench/configs/<config>.json

Operations: torch.utils.flop_counter.FlopCounterMode over the reference's
call (its matrix products, convolutions and attention products; a
multiply-add is 2). Bytes: every parameter and every input and output
tensor of the call once, at 2 bytes an element (bfloat16, the served
type). Every count is for one scene; a pass of N scenes does N times the
work, and a call over N scenes reads its parameters once:
bytes(N) = param_bytes + N * act_bytes.

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

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import reference

BYTES = 2  # bfloat16


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _numel(*ts) -> int:
    n = 0
    for t in ts:
        if isinstance(t, dict):
            n += _numel(*t.values())
        elif isinstance(t, (list, tuple)):
            n += _numel(*t)
        elif isinstance(t, torch.Tensor):
            n += t.numel()
    return n


def _params(module) -> int:
    return sum(p.numel() for p in module.parameters())


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
        counts = dict(
            unet=dict(flops=_flops(lambda: ref.unet(x_in, t2, ctx_in, levels)), param_bytes=BYTES * _params(ref.unet),
                      act_bytes=BYTES * _numel(x_in, t2, ctx_in, levels, unet_out)),
            gridattn=dict(flops=_flops(lambda: ref.view_attn(x, p.cams, t_embed, t, tables[1], tables[2], p.in_lat,
                                                            p.in_cams, jitter)),
                          param_bytes=BYTES * _params(ref.view_attn),
                          act_bytes=BYTES * _numel(x, p.cams, t_embed, p.in_lat, p.in_cams, jitter, frustum)),
            step=dict(flops=_flops(lambda: reference.apply_model_cfg(ref, p, x, t, jitter, inf["cfg_scale"], tables))),
            encode_image=dict(flops=_flops(lambda: reference.encode(ref, img1)), param_bytes=BYTES * _params(vae.encoder),
                              act_bytes=BYTES * _numel(img1, lat1)),
            clip_image=dict(flops=_flops(lambda: clip(reference.clip_preprocess(img1))),
                            param_bytes=BYTES * _params(clip), act_bytes=BYTES * (_numel(img1) + ctx)),
            decode_view=dict(flops=_flops(lambda: reference.decode(ref, lat1)), param_bytes=BYTES * _params(vae.decoder),
                             act_bytes=BYTES * _numel(img1, lat1)),
        )
    return counts


HOW = ("portbench/counts.py: torch.utils.flop_counter.FlopCounterMode over portbench/reference.py on the meta device "
       "at this file's shapes (a multiply-add is 2 operations); bytes are every parameter and every input and output "
       "tensor of the call once at 2 bytes an element. Per scene; bytes(N scenes) = param_bytes + N * act_bytes.")


def main(argv=None) -> int:
    for path in argv if argv is not None else sys.argv[1:]:
        with open(path) as fp:
            config = json.load(fp)
        config["counts"] = count(config)
        config["counted"] = HOW
        with open(path, "w") as fp:
            json.dump(config, fp, indent=1)
            fp.write("\n")
        print(path, json.dumps(config["counts"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
