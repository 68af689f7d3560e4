"""Load the JAX package's params into the port's ViewFusion.

The table maps every reference state-dict key (the port's parameter names)
to the flax param path(s) it comes from and the layout change: Linear
(in, out) -> (out, in), Conv HWIO -> OIHW, 1x1 conv (in, out) -> (out, in,
1, 1), and CLIP's split q/k/v projections -> the packed in_proj. It is the
port's own copy of the JAX package's mapping (convert/mapping.py), inverted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from mvdfusion_tpu_torch.parallel.mesh import full_shape, shard_like

Path = Tuple[str, ...]
# torch key -> (list of flax paths, layout kind)
Table = Dict[str, Tuple[List[Path], str]]

_TO_TORCH = {
    "none": lambda ws: ws[0],
    "linear": lambda ws: ws[0].T,
    "conv": lambda ws: np.transpose(ws[0], (3, 2, 0, 1)),
    "conv1x1": lambda ws: ws[0].T[:, :, None, None],
    "qkv": lambda ws: np.concatenate([w.T for w in ws], axis=0),
    "qkvb": lambda ws: np.concatenate(ws, axis=0),
}


def _dense(t: Table, f: Path, k: str, bias: bool = True):
    t[k + ".weight"] = ([f + ("kernel",)], "linear")
    if bias:
        t[k + ".bias"] = ([f + ("bias",)], "none")


def _conv(t: Table, f: Path, k: str, bias: bool = True, kind: str = "conv"):
    t[k + ".weight"] = ([f + ("kernel",)], kind)
    if bias:
        t[k + ".bias"] = ([f + ("bias",)], "none")


def _norm(t: Table, f: Path, k: str, kind: str = "GroupNorm_0"):
    t[k + ".weight"] = ([f + (kind, "scale")], "none")
    t[k + ".bias"] = ([f + (kind, "bias")], "none")


def _block(t: Table, f: Path, k: str):
    for a in ("attn1", "attn2"):
        for p in ("to_q", "to_k", "to_v"):
            _dense(t, f + (a, p), f"{k}.{a}.{p}", bias=False)
        _dense(t, f + (a, "to_out"), f"{k}.{a}.to_out.0")
    _dense(t, f + ("ff", "geglu", "proj"), k + ".ff.net.0.proj")
    _dense(t, f + ("ff", "out"), k + ".ff.net.2")
    for n in ("norm1", "norm2", "norm3"):
        _norm(t, f + (n,), f"{k}.{n}", "LayerNorm_0")


def _spatial(t: Table, f: Path, k: str, depth: int):
    _norm(t, f + ("norm",), k + ".norm")
    _conv(t, f + ("proj_in",), k + ".proj_in", kind="conv1x1")
    for d in range(depth):
        _block(t, f + (f"block_{d}",), f"{k}.transformer_blocks.{d}")
    _conv(t, f + ("proj_out",), k + ".proj_out", kind="conv1x1")


def _view_aligned(t: Table, f: Path, k: str, depth: int):
    _norm(t, f + ("norm",), k + ".aligned_attn_norm")
    _dense(t, f + ("proj_in",), k + ".aligned_attn_proj_in")
    for d in range(depth):
        _block(t, f + (f"block_{d}",), f"{k}.aligned_attn_transformer_blocks.{d}")
    _dense(t, f + ("proj_out",), k + ".aligned_attn_proj_out")


def _res(t: Table, f: Path, k: str, skip: bool):
    _norm(t, f + ("norm1",), k + ".in_layers.0")
    _conv(t, f + ("conv1",), k + ".in_layers.2")
    _dense(t, f + ("emb_proj",), k + ".emb_layers.1")
    _norm(t, f + ("norm2",), k + ".out_layers.0")
    _conv(t, f + ("conv2",), k + ".out_layers.3")
    if skip:
        _conv(t, f + ("skip",), k + ".skip_connection", kind="conv1x1")


def _unet(t: Table, cfg, f0: Path, p: str):
    mc, mult, nrb, depth = cfg.unet_model_channels, cfg.unet_channel_mult, cfg.unet_num_res_blocks, cfg.unet_transformer_depth
    attn = set(cfg.unet_attention_resolutions)
    _dense(t, f0 + ("time_dense1",), p + "time_embed.0")
    _dense(t, f0 + ("time_dense2",), p + "time_embed.2")
    _conv(t, f0 + ("conv_in",), p + "input_blocks.0.0")
    ch, ds, idx = mc, 1, 1
    for level, m in enumerate(mult):
        for i in range(nrb):
            in_ch, ch = ch, m * mc
            _res(t, f0 + (f"down_{level}_res_{i}",), f"{p}input_blocks.{idx}.0", in_ch != ch)
            if ds in attn:
                _spatial(t, f0 + (f"down_{level}_attn_{i}",), f"{p}input_blocks.{idx}.1", depth)
            idx += 1
        if level != len(mult) - 1:
            _conv(t, f0 + (f"down_{level}_downsample", "conv"), f"{p}input_blocks.{idx}.0.op")
            idx += 1
            ds *= 2
    _res(t, f0 + ("mid_res_0",), p + "middle_block.0", False)
    _spatial(t, f0 + ("mid_attn",), p + "middle_block.1", depth)
    _view_aligned(t, f0 + ("mid_view_attn",), p + "middle_block.2", depth)
    _res(t, f0 + ("mid_res_1",), p + "middle_block.3", False)
    idx = 0
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            _res(t, f0 + (f"up_{level}_res_{i}",), f"{p}output_blocks.{idx}.0", True)
            sub = 1
            if ds in attn:
                _spatial(t, f0 + (f"up_{level}_attn_{i}",), f"{p}output_blocks.{idx}.{sub}", depth)
                _view_aligned(t, f0 + (f"up_{level}_view_attn_{i}",), f"{p}output_blocks.{idx}.{sub + 1}", depth)
                sub += 2
            if level and i == nrb:
                _conv(t, f0 + (f"up_{level}_upsample", "conv"), f"{p}output_blocks.{idx}.{sub}.conv")
                ds //= 2
            idx += 1
    _norm(t, f0 + ("norm_out",), p + "out.0")
    _conv(t, f0 + ("conv_out",), p + "out.2")


def _vae_res(t: Table, f: Path, k: str, shortcut: bool):
    _norm(t, f + ("norm1",), k + ".norm1")
    _conv(t, f + ("conv1",), k + ".conv1")
    _norm(t, f + ("norm2",), k + ".norm2")
    _conv(t, f + ("conv2",), k + ".conv2")
    if shortcut:
        _conv(t, f + ("nin_shortcut",), k + ".nin_shortcut", kind="conv1x1")


def _vae_mid(t: Table, f: Path, k: str):
    _vae_res(t, f + ("mid_block_1",), k + ".mid.block_1", False)
    _norm(t, f + ("mid_attn_1", "norm"), k + ".mid.attn_1.norm")
    for n in ("q", "k", "v", "proj_out"):
        _conv(t, f + ("mid_attn_1", n), f"{k}.mid.attn_1.{n}", kind="conv1x1")
    _vae_res(t, f + ("mid_block_2",), k + ".mid.block_2", False)


def _vae(t: Table, cfg, f0: Path, p: str):
    ch, mult, nrb = cfg.vae_ch, cfg.vae_ch_mult, cfg.vae_num_res_blocks
    enc, dec = f0 + ("encoder",), f0 + ("decoder",)
    _conv(t, enc + ("conv_in",), p + "encoder.conv_in")
    b_in = ch
    for level, m in enumerate(mult):
        for i in range(nrb):
            _vae_res(t, enc + (f"down_{level}_block_{i}",), f"{p}encoder.down.{level}.block.{i}", b_in != ch * m)
            b_in = ch * m
        if level != len(mult) - 1:
            _conv(t, enc + (f"down_{level}_downsample", "conv"), f"{p}encoder.down.{level}.downsample.conv")
    _vae_mid(t, enc, p + "encoder")
    _norm(t, enc + ("norm_out",), p + "encoder.norm_out")
    _conv(t, enc + ("conv_out",), p + "encoder.conv_out")
    _conv(t, dec + ("conv_in",), p + "decoder.conv_in")
    _vae_mid(t, dec, p + "decoder")
    b_in = ch * mult[-1]
    for level in reversed(range(len(mult))):
        for i in range(nrb + 1):
            _vae_res(t, dec + (f"up_{level}_block_{i}",), f"{p}decoder.up.{level}.block.{i}", b_in != ch * mult[level])
            b_in = ch * mult[level]
        if level != 0:
            _conv(t, dec + (f"up_{level}_upsample", "conv"), f"{p}decoder.up.{level}.upsample.conv")
    _norm(t, dec + ("norm_out",), p + "decoder.norm_out")
    _conv(t, dec + ("conv_out",), p + "decoder.conv_out")
    _conv(t, f0 + ("quant_conv",), p + "quant_conv", kind="conv1x1")
    _conv(t, f0 + ("post_quant_conv",), p + "post_quant_conv", kind="conv1x1")


def _clip(t: Table, cfg, f0: Path, p: str):
    v = f0 + ("visual",)
    t[p + "conv1.weight"] = ([v + ("patch_embed", "kernel")], "conv")
    for n in ("class_embedding", "positional_embedding", "proj"):
        t[p + n] = ([v + (n,)], "none")
    _norm(t, v + ("ln_pre",), p + "ln_pre", "LayerNorm_0")
    _norm(t, v + ("ln_post",), p + "ln_post", "LayerNorm_0")
    for i in range(cfg.clip_layers):
        b, k = v + (f"block_{i}",), f"{p}transformer.resblocks.{i}"
        t[k + ".attn.in_proj_weight"] = ([b + ("attn", f"{w}_proj", "kernel") for w in "qkv"], "qkv")
        t[k + ".attn.in_proj_bias"] = ([b + ("attn", f"{w}_proj", "bias") for w in "qkv"], "qkvb")
        _dense(t, b + ("attn", "out_proj"), k + ".attn.out_proj")
        _norm(t, b + ("ln_1",), k + ".ln_1", "LayerNorm_0")
        _norm(t, b + ("ln_2",), k + ".ln_2", "LayerNorm_0")
        _dense(t, b + ("mlp_fc",), k + ".mlp.c_fc")
        _dense(t, b + ("mlp_proj",), k + ".mlp.c_proj")


def _viewattn(t: Table, cfg, f0: Path, p: str):
    _dense(t, f0 + ("z_embedder",), p + "z_embedder.0")
    _dense(t, f0 + ("pre_layer",), p + "pre_layer_b.0")
    for i in range(cfg.viewattn_layers):
        b, k = f0 + ("aggregator", f"block_{i}"), f"{p}aggregation_transformer.layer_list.{i}"
        _dense(t, b + ("attn", "qkv"), k + ".attn.qkv")
        _dense(t, b + ("attn", "proj"), k + ".attn.proj")
        _dense(t, b + ("mlp", "fc1"), k + ".mlp.fc1")
        _dense(t, b + ("mlp", "fc2"), k + ".mlp.fc2")
        _dense(t, b + ("adaLN",), k + ".adaLN_modulation.1")
    _dense(t, f0 + ("aggregator", "weight_layer"), p + "aggregation_transformer.weight_layer")
    _dense(t, f0 + ("final_layer",), p + "final_layer_b")


def viewfusion_table(cfg) -> Table:
    """Every ViewFusion parameter: torch key -> (flax paths, layout kind)."""
    t: Table = {}
    _unet(t, cfg, ("unet",), "unet_model.unet_model.")
    _vae(t, cfg, ("vae",), "vae.")
    _clip(t, cfg, ("clip",), "clip_image_encoder.model.visual.")
    _viewattn(t, cfg, ("view_attn",), "view_attn.")
    if cfg.embed_camera_pose:
        for i, tidx in enumerate((0, 2, 4)):
            _dense(t, (f"cc_layers_{i}",), f"cc_projection.{tidx}")
    else:  # the legacy pose path's one layer
        _dense(t, ("cc_layers_0",), "cc_projection")
    _dense(t, ("time_dense1",), "time_embed.0")
    _dense(t, ("time_dense2",), "time_embed.2")
    return t


def load_flax_params(model, flat: Dict[str, np.ndarray]) -> None:
    """Copy JAX params, given flat as {"path/to/leaf": array} (a leading
    "params/" is optional), into the port's ViewFusion in place; every
    parameter of the model must be covered and every shape must match (the
    whole shape: a model split over tp takes each rank's slice)."""
    flat = {k[len("params/"):] if k.startswith("params/") else k: v for k, v in flat.items()}
    table = viewfusion_table(model.cfg)
    params = dict(model.named_parameters())
    state = model.state_dict()
    missing = sorted(set(state) - set(table))
    if missing:
        raise KeyError(f"no mapping for {len(missing)} parameters, e.g. {missing[:3]}")
    new = {}
    for key, (paths, kind) in table.items():
        arrays = [np.asarray(flat["/".join(p)], np.float32) for p in paths]
        w = _TO_TORCH[kind](arrays)
        if tuple(w.shape) != full_shape(params[key]):
            raise ValueError(f"{key}: {w.shape} from JAX vs {full_shape(params[key])} in the port")
        new[key] = shard_like(torch.as_tensor(np.ascontiguousarray(w), dtype=state[key].dtype), params[key])
    model.load_state_dict(new, strict=True)
