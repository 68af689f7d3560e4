"""MVDream (arXiv 2308.16512; github.com/bytedance/MVDream), text to four
views at once: Stable Diffusion 2.1-base whose UNet attends over the four
views' tokens joined in every self-attention and adds a camera embedding to
the time embedding.

  MVDream          the UNet (nn/unet.py::UNetModel under MVDream's
                   options), the OpenCLIP text tower (nn/clip.py), the SD
                   VAE's decoder (nn/vae.py)
  get_camera       mvdream/camera_utils.py::get_camera: each view's
                   camera-to-world matrix, flattened to 16 numbers
  encode_text      token ids -> the text tower's (B, 77, 1024) context
  apply_model_cfg  one UNet call over the CFG batch [uncond | cond], mixed
  decode_latents   latents -> [0, 1] NHWC images

State-dict names follow the published checkpoint (sd-v2.1-base-4view):
model.diffusion_model.*, cond_stage_model.model.*,
first_stage_model.decoder.* and first_stage_model.post_quant_conv.*. The
text tower's and the UNet's calls are spans of utils/trace.py
(`model.text`, `model.unet`); pipeline/sampler.py::ddim_sample_views runs
the DDIM loop over them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from mvdfusion_tpu_torch.core.config import MVDreamConfig
from mvdfusion_tpu_torch.nn.clip import FrozenOpenCLIPEmbedder
from mvdfusion_tpu_torch.nn.layers import Conv1x1, GroupNorm32, LayerNormFp32
from mvdfusion_tpu_torch.nn.unet import UNetModel
from mvdfusion_tpu_torch.nn.vae import Decoder
from mvdfusion_tpu_torch.utils.common import unnormalize
from mvdfusion_tpu_torch.utils.trace import span

# OpenGL camera axes to Blender's (camera_utils.py::convert_opengl_to_blender)
_GL_TO_BLENDER = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)


def camera_to_world(elevation_deg: float, azimuth_deg: float) -> np.ndarray:
    """(4, 4) camera-to-world of a camera on the unit sphere looking at the
    origin, +y up, OpenGL axes (camera_utils.py::create_camera_to_world_matrix)."""
    e, a = np.radians(elevation_deg), np.radians(azimuth_deg)
    pos = np.array([np.cos(e) * np.sin(a), np.sin(e), np.cos(e) * np.cos(a)])
    forward = -pos / np.linalg.norm(pos)
    right = np.cross(forward, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    up /= np.linalg.norm(up)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up, -forward], axis=1)
    c2w[:3, 3] = pos
    return c2w


def get_camera(num_frames: int, elevation: float = 15.0, azimuth_start: float = 0.0,
               azimuth_span: float = 360.0) -> torch.Tensor:
    """(num_frames, 16) float32: views at azimuths azimuth_start + k span /
    num_frames, each camera-to-world in Blender's axes, flattened."""
    gap = azimuth_span / num_frames
    azims = np.arange(azimuth_start, azimuth_span + azimuth_start, gap)[:num_frames]
    cams = [(_GL_TO_BLENDER @ camera_to_world(elevation, a)).reshape(16) for a in azims]
    return torch.tensor(np.stack(cams), dtype=torch.float32)


class _Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class FirstStageDecoder(nn.Module):
    """The SD VAE's decoding half: post_quant_conv, then the decoder."""

    def __init__(self, embed_dim=4, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        self.decoder = Decoder(ch, 3, ch_mult, num_res_blocks, z_channels)
        self.post_quant_conv = Conv1x1(embed_dim, z_channels)

    def forward(self, z):
        return self.decoder(self.post_quant_conv(z))


class MVDream(nn.Module):
    """Built on `device`: the card unless the caller names another."""

    def __init__(self, cfg: MVDreamConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        with torch.device(device):
            self.model = _Holder(diffusion_model=UNetModel(
                c.in_channels, c.model_channels, c.out_channels, c.num_res_blocks, c.attention_resolutions,
                c.channel_mult, transformer_depth=c.transformer_depth, context_dim=c.context_dim,
                num_head_channels=c.num_head_channels, use_linear_in_transformer=c.use_linear_in_transformer,
                view_aligned=False, camera_dim=c.camera_dim, num_frames=c.num_frames,
            ))
            self.cond_stage_model = FrozenOpenCLIPEmbedder(c.text_vocab_size, c.text_context_length, c.text_width,
                                                           c.text_layers, c.text_heads)
            self.first_stage_model = FirstStageDecoder(c.vae_embed_dim, c.vae_ch, c.vae_ch_mult,
                                                       c.vae_num_res_blocks, c.vae_z_channels)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    def cast_for_inference(self):
        """Every parameter to cfg.dtype once, but the GroupNorm and LayerNorm
        parameters, which stay fp32."""
        norms = {id(p) for m in self.modules() if isinstance(m, (GroupNorm32, LayerNormFp32))
                 for p in m.parameters(recurse=False)}
        for p in self.parameters():
            p.data = p.data.to(torch.float32 if id(p) in norms else self.cfg.dtype)
        return self

    def encode_text(self, tokens):
        """(B, 77) token ids -> (B, 77, context_dim) context."""
        with span("model.text"):
            return self.cond_stage_model(tokens)

    def apply_model_cfg(self, x, t, context, uncond_context, camera, cfg_scale):
        """Classifier-free-guided noise of N requests: x (N, F, h, w, C) at
        timestep t (scalar), context (N, M, ctx), uncond_context (1, M, ctx),
        camera (N, F, 16). One UNet call over the 2NF batch laid out as
        t2i.py's sampler lays it, [uncond | cond] with each request's F
        views consecutive; returns e_u + cfg_scale (e_c - e_u)."""
        N, F = x.shape[:2]
        views = lambda a: a.repeat_interleave(F, dim=0)
        ctx = torch.cat([uncond_context.expand(N * F, *uncond_context.shape[1:]), views(context)])
        cam = camera.reshape(N * F, -1)
        xv = x.reshape(N * F, *x.shape[2:])
        with span("model.unet"):
            e = self.unet(torch.cat([xv, xv]), t.expand(2 * N * F), ctx, camera=torch.cat([cam, cam]))
        e_u, e_c = e[: N * F], e[N * F:]
        return (e_u + cfg_scale * (e_c - e_u)).reshape(x.shape)

    def decode_latents(self, z):
        """(B, h, w, 4) latents -> (B, H, W, 3) images in [0, 1], fp32."""
        return unnormalize(self.first_stage_model(z / self.cfg.scale_factor).float())
