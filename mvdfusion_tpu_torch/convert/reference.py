"""Load the reference's weight files into the port's ViewFusion, in place
(the port's counterpart of mvdfusion_tpu/convert/torch_to_flax.py).

The four files the reference reads (its README.md:43-45):
  * weights/mvdfusion_sep23.pt      the whole ViewFusion (`load_viewfusion`);
                                    the port's parameter names are that
                                    file's keys
  * weights/zero123_105000.ckpt     the SD UNet of zero123 before the
                                    ViewAligned layers were grafted in
                                    (`load_zero123_unet`: the
                                    model.diffusion_model. prefix strip, the
                                    param_mapper shift, the shape-changed
                                    conv drops) and the SD VAE (`load_sd_vae`)
  * weights/clip_vit_14.ckpt        the OpenAI CLIP TorchScript archive
                                    (`load_clip`: its visual.* tower)
  * weights/zero123_105000_cc.ckpt  the legacy cc_projection
                                    (`load_zero123_cc`)

Each loader checks every shape before it writes anything, then copies each
tensor with `param.copy_` under no_grad onto the parameter's own device and
dtype. copy_ moves the parameter's version, so the weights the kernels
prepare once a parameter (ops/_lib.py::cached) are rebuilt at their next use.
"""

from __future__ import annotations

import zipfile
from typing import Dict, List, Mapping, NamedTuple

import torch

from mvdfusion_tpu_torch.convert.surgery import ZERO123_PARAM_MAPPER, ZERO123_REMOVE_KEYS, apply_surgery, report_load


def load_torch_state(path: str) -> Dict[str, object]:
    """A checkpoint's state dict on the CPU: torch.load (zipfile files
    mapped rather than read; a TorchScript archive, which torch.load hands
    to torch.jit.load, as its module), then .state_dict() of a module and
    the `model_state_dict` / `state_dict` entry of a dict unwrapped.
    weights_only=False: a zero123 .ckpt is a Lightning pickle, which the
    default (weights_only=True since torch 2.6) refuses."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False, mmap=zipfile.is_zipfile(path))
    except RuntimeError:
        obj = torch.jit.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    return dict(obj)


class ConvertStats(NamedTuple):
    """What a load did, by name: `written` the model's keys that took a
    file tensor, `missing` the model's keys (in the loader's scope) that no
    file key covers (they keep their values), `unused` the file's keys that
    no model key took."""

    written: List[str]
    missing: List[str]
    unused: List[str]


def load_state(model, state: Mapping[str, object], prefix: str = "", scope: str = "", strict: bool = True,
               verbose: bool = True) -> ConvertStats:
    """Copy file key k of `state` into the model's parameter `prefix + k`,
    for the model's keys that start with `scope`. Every shape is checked
    first (a mismatch raises ValueError naming the key); with `strict` a
    model key in scope that no file key covers raises KeyError naming it."""
    params = {n: p for n, p in model.state_dict(keep_vars=True).items() if n.startswith(scope)}
    pairs = {prefix + k: v for k, v in state.items() if (prefix + k) in params}
    for key, v in pairs.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else None
        if shape != tuple(params[key].shape):
            raise ValueError(f"[convert] shape mismatch at {key}: file {shape} vs model {tuple(params[key].shape)}")
    missing, _ = report_load(params, [prefix + k for k in state], verbose=verbose)
    unused = [k for k in state if (prefix + k) not in pairs]
    if strict and missing:
        raise KeyError(f"[convert] strict load failed: {len(missing)} model keys with no file key, e.g. {missing[:3]}")
    with torch.no_grad():
        for key, v in pairs.items():
            p = params[key]
            p.copy_(v.to(p.dtype))
    if verbose:
        print(f"[convert] wrote {len(pairs)}/{len(params)} tensors")
    return ConvertStats(written=list(pairs), missing=missing, unused=unused)


def load_viewfusion(model, path: str, strict: bool = True, verbose: bool = True) -> ConvertStats:
    """A whole-ViewFusion file (weights/mvdfusion_sep23.pt, demo.py:161-169).
    strict: it must cover every parameter. Its dead keys (scheduler.*,
    view_attn.t_embedder.*, the CLIP text tower's leftovers) come back as
    unused."""
    return load_state(model, load_torch_state(path), strict=strict, verbose=verbose)


UNET_PREFIX = "unet_model.unet_model."


def load_zero123_unet(model, path: str, verbose: bool = True) -> ConvertStats:
    """The zero123 SD UNet with the reference's key surgery (unet.py:88-93),
    into unet_model.unet_model.*. Not strict: the grafted ViewAligned rows
    (aligned_attn_*) and the three shape-changed convs are not in such a
    file and keep their values (viewfusion_zero_depth_rgb.py:64-69)."""
    state = apply_surgery(
        load_torch_state(path),
        replace_key=("model.diffusion_model.", ""),
        param_mapper=ZERO123_PARAM_MAPPER,
        remove_keys=ZERO123_REMOVE_KEYS,
        ignore_keys=("aligned_attn_",),
    )
    return load_state(model, state, prefix=UNET_PREFIX, scope=UNET_PREFIX, strict=False, verbose=verbose)


def load_sd_vae(model, path: str, strict: bool = True, verbose: bool = True) -> ConvertStats:
    """The SD VAE (viewfusion:75: the first_stage_model. prefix replaced)
    into vae.*."""
    state = apply_surgery(load_torch_state(path), replace_key=("first_stage_model.", ""))
    return load_state(model, state, prefix="vae.", scope="vae.", strict=strict, verbose=verbose)


def load_clip(model, path: str, strict: bool = True, verbose: bool = True) -> ConvertStats:
    """The OpenAI CLIP ViT-L/14 archive's visual.* tower
    (encoders/modules.py:414) into clip_image_encoder.model.visual.*; the
    text tower's keys come back as unused."""
    p = "clip_image_encoder.model."
    return load_state(model, load_torch_state(path), prefix=p, scope=p, strict=strict, verbose=verbose)


def load_zero123_cc(model, path: str, verbose: bool = True) -> ConvertStats:
    """The legacy pose path's cc_projection (weights/zero123_105000_cc.ckpt):
    one Linear(context_dim + 4, context_dim) under cc_projection.{weight,
    bias}. The reference loads the file over the whole model with
    strict=False and asserts no unexpected key
    (viewfusion_zero_depth_rgb.py:112-121): a key outside cc_projection
    raises here, as does a model with embed_camera_pose=True (whose
    cc_projection is the 3-layer MLP)."""
    if model.cfg.embed_camera_pose:
        raise ValueError("zero123_cc loads the legacy delta-pose cc_projection; the config has "
                         "embed_camera_pose=True (3-layer MLP) - see viewfusion_zero_depth_rgb.py:108-121")
    state = load_torch_state(path)
    targets = {n for n in model.state_dict() if n.startswith("cc_projection.")}
    stray = [k for k in state if k not in targets]
    if stray:
        raise ValueError(f"[convert] zero123_cc ckpt has {len(stray)} keys outside cc_projection "
                         f"(e.g. {stray[:3]}) - the reference asserts len(unexpected) == 0")
    return load_state(model, state, scope="cc_projection.", strict=True, verbose=verbose)
