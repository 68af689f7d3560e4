"""YAML configs (counterpart of mvdfusion_tpu/core/config.py).

The same files drive both packages (configs/*.yaml, the reference's
`target:` / `params:` layout). The model section flattens into one
`ViewFusionConfig`, the trainer section (with the model's finetune flags)
into one `TrainConfig`; the dataset section names a loader by the
reference's dotted target or a native name. PyYAML is imported where a file
is read. `MVDreamConfig` holds the second architecture's sizes
(nn/mvdream.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from mvdfusion_tpu_torch.nn.viewfusion import ViewFusionConfig


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as fp:
        return yaml.safe_load(fp)


@dataclasses.dataclass(frozen=True)
class MVDreamConfig:
    """MVDream's sizes (github.com/bytedance/MVDream,
    mvdream/configs/sd-v2-base.yaml; scripts/t2i.py's --num_frames). Fields
    take the yaml's key names: the model's params and unet_config's params
    bare, first_stage_config's ddconfig and embed_dim behind `vae_`,
    cond_stage_config's behind `text_` (OpenCLIP ViT-H/14's text tower,
    read at its layer "penultimate": nn/clip.py::FrozenOpenCLIPEmbedder)."""

    linear_start: float = 0.00085
    linear_end: float = 0.0120
    timesteps: int = 1000
    scale_factor: float = 0.18215
    image_size: int = 32  # the latent's side
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    use_linear_in_transformer: bool = True
    transformer_depth: int = 1
    context_dim: int = 1024
    camera_dim: int = 16
    num_frames: int = 4
    vae_embed_dim: int = 4
    vae_z_channels: int = 4
    vae_ch: int = 128
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    text_vocab_size: int = 49408
    text_context_length: int = 77
    text_width: int = 1024
    text_layers: int = 24
    text_heads: int = 16
    # compute dtype of the towers (norms stay fp32)
    dtype: Any = torch.bfloat16

    def tiny(self) -> "MVDreamConfig":
        """CPU test sizes: three UNet levels of 32-64 channels, 8-wide heads,
        an 8x8 latent, a 3-layer text tower of width 64."""
        return dataclasses.replace(
            self, image_size=8, model_channels=32, channel_mult=(1, 2, 2), num_res_blocks=1, num_head_channels=8,
            context_dim=64, vae_ch=32, vae_ch_mult=(1, 2), vae_num_res_blocks=1, text_vocab_size=1000,
            text_width=64, text_layers=3, text_heads=2, dtype=torch.float32,
        )


# ---------------------------------------------------------------- datasets
def _dataset_registry() -> Dict[str, Callable]:
    from mvdfusion_tpu_torch.data.datasets import GSO, Objaverse, Wild

    return {
        # the reference's dotted targets (configs/mvd_*.yaml)
        "dataset.gso_test.GSO": GSO,
        "dataset.wild_test.GSO": Wild,  # wild_test's class is also named GSO
        "dataset.objaverse.Objaverse": Objaverse,
        # native names
        "mvdfusion_tpu.data.datasets.GSO": GSO,
        "mvdfusion_tpu.data.datasets.Wild": Wild,
        "mvdfusion_tpu.data.datasets.Objaverse": Objaverse,
        "mvdfusion_tpu_torch.data.datasets.GSO": GSO,
        "mvdfusion_tpu_torch.data.datasets.Wild": Wild,
        "mvdfusion_tpu_torch.data.datasets.Objaverse": Objaverse,
        "gso": GSO,
        "wild": Wild,
        "objaverse": Objaverse,
    }


def build_dataset(cfg: dict):
    section = cfg["dataset"]
    target = section["target"]
    registry = _dataset_registry()
    if target not in registry:
        raise KeyError(f"unknown dataset target {target!r}")
    return registry[target](**section.get("params", {}))


# ------------------------------------------------------------------- model
def build_model_config(cfg: dict, dtype=torch.bfloat16) -> ViewFusionConfig:
    """Flatten the model section into a ViewFusionConfig."""
    mp = cfg["model"]["params"]
    va = mp.get("view_attn_config", {}).get("params", {})
    un = mp.get("unet_config", {}).get("params", {})
    dd = mp.get("ddpm_config", {}).get("params", {})
    vae = mp.get("vae_config", {}).get("params", {})
    ddcfg = vae.get("ddconfig", {})
    return ViewFusionConfig(
        z_scale_factor=mp.get("z_scale_factor", 0.18215),
        embed_camera_pose=mp.get("embed_camera_pose", True),
        drop_conditions=mp.get("drop_conditions", False),
        objective=mp.get("objective", "noise"),
        loss_type=mp.get("loss_type", "l2"),
        feed_prev_depth=mp.get("feed_prev_depth", False),
        timesteps=dd.get("timesteps", 1000),
        latent_size=va.get("input_size", 32),
        viewattn_hidden=va.get("hidden_size", 256),
        viewattn_layers=va.get("num_layers", 3),
        viewattn_heads=va.get("num_heads", 8),
        viewattn_mlp_ratio=va.get("mlp_ratio", 2.0),
        n_pts_per_ray=va.get("n_pts_per_ray", 1),
        keep_top_k_views=va.get("keep_top_k_views", False),
        top_k=va.get("top_k", 4),
        unet_in_channels=un.get("in_channels", 10),
        unet_out_channels=un.get("out_channels", 5),
        unet_model_channels=un.get("model_channels", 320),
        unet_num_res_blocks=un.get("num_res_blocks", 2),
        unet_attention_resolutions=tuple(un.get("attention_resolutions", (4, 2, 1))),
        unet_channel_mult=tuple(un.get("channel_mult", (1, 2, 4, 4))),
        unet_num_heads=un.get("num_heads", 8),
        unet_transformer_depth=un.get("transformer_depth", 1),
        context_dim=un.get("context_dim", 768),
        vae_embed_dim=vae.get("embed_dim", 4),
        vae_ch=ddcfg.get("ch", 128),
        vae_ch_mult=tuple(ddcfg.get("ch_mult", (1, 2, 4, 4))),
        vae_num_res_blocks=ddcfg.get("num_res_blocks", 2),
        dtype=dtype,
    )


# ----------------------------------------------------------------- trainer
def build_train_config(cfg: dict):
    """The trainer section and the model's finetune flags as a TrainConfig
    (the reference configs carry a misspelt `finteune_view_attn`: honoured
    where `finetune_view_attn` is absent)."""
    from mvdfusion_tpu_torch.pipeline.trainer import TrainConfig

    mp = cfg["model"]["params"]
    tr = cfg.get("trainer", {})
    return TrainConfig(
        lr=float(tr.get("lr", cfg["model"].get("base_learning_rate", 1e-4))),
        grad_accum_step=int(tr.get("grad_accum_step", 1)),
        grad_clip=float(tr.get("grad_clip", 0.0)),
        skip_nonfinite=bool(tr.get("skip_nonfinite", False)),
        lr_schedule=str(tr.get("lr_schedule", "constant")),
        lr_decay_steps=int(tr.get("lr_decay_steps", 0)),
        lr_alpha=float(tr.get("lr_alpha", 0.1)),
        ema_decay=float(tr.get("ema_decay", 0.0)),
        finetune_projection=mp.get("finetune_projection", True),
        finetune_unet=mp.get("finetune_unet", False),
        finetune_cross_attn=mp.get("finetune_cross_attn", True),
        finetune_view_attn=mp.get("finetune_view_attn", mp.get("finteune_view_attn", True)),
    )
