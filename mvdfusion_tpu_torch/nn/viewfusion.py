"""ViewFusion, the top-level multi-view RGB-D latent diffusion model (torch
counterpart of mvdfusion_tpu/nn/viewfusion.py).

Owns the UNet, VAE, CLIP tower, GridAttn, the eye-initialised cc_projection
and the auxiliary time-embed MLP, with the state-dict names of the reference
checkpoint (unet_model.unet_model.*, vae.*, clip_image_encoder.model.visual.*,
view_attn.*, cc_projection.{0,2,4}, time_embed.{0,2}; with
embed_camera_pose=False the legacy zero123 cc_projection.{weight,bias}).

  prepare_batch    VAE encode, depth channels, relative cameras, CLIP + pose
                   (the 28-dim camera embedding, or the legacy 4-dim
                   delta-pose vector from azimuth and elevation)
  apply_model      GridAttn -> cc_projection -> UNet, one conditional pass
                   with the training-time condition dropout
  apply_model_cfg  GridAttn -> cc_projection -> UNet over one 2B batch (cond
                   and null conditioning together), then CFG mixing
  p_losses         the training loss: shared-t L2 on the noise or x_start
  decode_latents   VAE decode to [0, 1] images (decode_latents_chunked: in
                   batches of at most 8 views)

`cfg.fuse_mode` ("auto" or "never") picks the UNet sites' and GridAttn's
kernels or their module paths; pipeline/trainer.py runs the train step
under its own (`TrainConfig.train_fuse_mode`, "never" by default).
Randomness comes from a torch.Generator or is given explicitly.

`mesh` (set by parallel/mesh.py::shard_params_) places the model on a
(dp, sp, tp) mesh. Its tp axis splits the towers' layers (nn/layers.py).
On its sp axis p_losses splits a scene's target views: each rank encodes
its views' latents and gathers all V (`gather_rows`), draws every view's
noise as one rank does, and runs GridAttn's queries and the UNet on its
views only (apply_model's `views`); its loss is its views' squared errors
over the scene's whole count, times sp, so that the mean over the sp ranks
(the trainer's gradient average, the reported loss) is the scene's loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.nn as nn

from mvdfusion_tpu_torch.core.schedule import make_ddpm_schedule, q_sample
from mvdfusion_tpu_torch.geometry.cameras import Cameras, camera_slice, make_cameras, relative_cameras
from mvdfusion_tpu_torch.nn.clip import FrozenCLIPImageEmbedder
from mvdfusion_tpu_torch.nn.layers import GroupNorm32, LayerNormFp32, Linear, consumed, silu, timestep_embedding
from mvdfusion_tpu_torch.nn.unet import UNetModel, volume_pyramid
from mvdfusion_tpu_torch.nn.vae import AutoencoderKL
from mvdfusion_tpu_torch.nn.viewattn import GridAttn
from mvdfusion_tpu_torch.ops.image import area_downsample
from mvdfusion_tpu_torch.parallel.tensor import even_slices, gather_rows
from mvdfusion_tpu_torch.utils.common import normalize, unnormalize


@dataclasses.dataclass(frozen=True)
class ViewFusionConfig:
    """Static model hyperparameters (configs/mvd_gso.yaml `model.params`)."""

    z_scale_factor: float = 0.18215
    # the 28-dim camera embedding and the 3-layer cc_projection; False: the
    # legacy zero123 delta pose [d_elev, sin d_azim, cos d_azim, 0] and one
    # Linear(context_dim + 4, context_dim) (viewfusion_zero_depth_rgb.py:108-121)
    embed_camera_pose: bool = True
    # training: per-sample condition dropout in four disjoint 5% bands
    # (apply_model), the target of the L2 loss ("noise" or "x_start"), and
    # the loss (the reference has only "l2")
    drop_conditions: bool = False
    objective: str = "noise"
    loss_type: str = "l2"
    # feed each step's pred_x0 depth to the next step's GridAttn (sampler);
    # in training, the input latent's depth channel
    feed_prev_depth: bool = False
    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    time_embed_dim: int = 256
    latent_size: int = 32
    viewattn_hidden: int = 256
    viewattn_layers: int = 3
    viewattn_heads: int = 8
    viewattn_mlp_ratio: float = 2.0
    n_pts_per_ray: int = 1
    # GridAttn's static window of top_k + 1 views by index (general path)
    keep_top_k_views: bool = False
    top_k: int = 4
    unet_in_channels: int = 10
    unet_out_channels: int = 5
    unet_model_channels: int = 320
    unet_num_res_blocks: int = 2
    unet_attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    unet_channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    unet_num_heads: int = 8
    unet_transformer_depth: int = 1
    context_dim: int = 768
    vae_embed_dim: int = 4
    vae_ch: int = 128
    vae_ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    clip_width: int = 1024
    clip_layers: int = 24
    clip_heads: int = 16
    # compute dtype of the heavy towers (see ViewFusion.cast_for_inference)
    dtype: Any = torch.bfloat16
    # the UNet sites' and GridAttn's kernels where their gates are open
    # ("auto") or their module paths ("never")
    fuse_mode: str = "auto"
    # zero GridAttn's frustum before the UNet (the cross-view ablation)
    ablate_frustum: bool = False
    # recompute each UNet block's interior in the backward
    unet_remat: bool = False

    def tiny(self) -> "ViewFusionConfig":
        """The JAX package's scaled-down test config."""
        return dataclasses.replace(
            self,
            latent_size=16,
            viewattn_hidden=32,
            viewattn_layers=2,
            viewattn_heads=4,
            unet_model_channels=32,
            unet_num_res_blocks=1,
            unet_num_heads=4,
            context_dim=64,
            vae_ch=32,
            vae_ch_mult=(1, 2, 4),
            vae_num_res_blocks=1,
            clip_width=64,
            clip_layers=2,
            clip_heads=2,
            time_embed_dim=32,
            dtype=torch.float32,
        )


class _UNetWrapper(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.unet_model = unet


class ViewFusion(nn.Module):
    """Built on `device`: the card unless the caller names another."""

    def __init__(self, cfg: ViewFusionConfig, device="cuda"):
        super().__init__()
        with torch.device(device):
            self._build(cfg)
        self._sched = {}
        self.mesh = None  # parallel/mesh.py::shard_params_ sets it

    def sp_views(self, B: int):
        """(sp axis, each sp rank's slice of B target views), or None
        without an sp axis."""
        axis = None if self.mesh is None else self.mesh.axes["sp"]
        return None if axis is None or axis.size == 1 else (axis, even_slices(B, axis.size))

    def _build(self, cfg: ViewFusionConfig):
        self.cfg = c = cfg
        self.unet_model = _UNetWrapper(UNetModel(
            c.unet_in_channels, c.unet_model_channels, c.unet_out_channels, c.unet_num_res_blocks,
            c.unet_attention_resolutions, c.unet_channel_mult, c.unet_num_heads, c.unet_transformer_depth,
            c.context_dim,
        ))
        self.vae = AutoencoderKL(c.vae_embed_dim, c.vae_ch, c.vae_ch_mult, c.vae_num_res_blocks)
        self.clip_image_encoder = FrozenCLIPImageEmbedder(c.clip_width, c.clip_layers, c.clip_heads, c.context_dim)
        self.view_attn = GridAttn(
            in_channels=5, hidden_size=c.viewattn_hidden, output_dim=c.context_dim,
            num_heads=c.viewattn_heads, mlp_ratio=c.viewattn_mlp_ratio, num_layers=c.viewattn_layers,
            n_pts_per_ray=c.n_pts_per_ray, keep_top_k_views=c.keep_top_k_views, top_k=c.top_k,
        )
        d = c.context_dim
        # [clip | 28-dim pose embed] -> context, or [clip | 4-dim delta pose]
        # in the legacy layout; the first layer eye/zero initialised
        if c.embed_camera_pose:
            self.cc_projection = nn.ModuleList(
                [Linear(d + 28, d), nn.Identity(), Linear(d, d), nn.Identity(), Linear(d, d)]
            )
            first = self.cc_projection[0]
        else:
            self.cc_projection = first = Linear(d + 4, d)
        with torch.no_grad():
            first.weight.zero_()
            first.weight[:d, :d] = torch.eye(d)
            first.bias.zero_()
        self.time_embed = nn.ModuleList(
            [Linear(c.time_embed_dim, c.time_embed_dim), nn.Identity(), Linear(c.time_embed_dim, c.time_embed_dim)]
        )

    @property
    def unet(self) -> UNetModel:
        return self.unet_model.unet_model

    def sched(self, device):
        """The DDPM tables on `device` (built once per device)."""
        key = str(device)
        if key not in self._sched:
            c = self.cfg
            self._sched[key] = make_ddpm_schedule(c.timesteps, c.linear_start, c.linear_end, device=device)
        return self._sched[key]

    def compute_dtypes(self) -> dict:
        """Each parameter's compute dtype, by state-dict name: cfg.dtype for
        the towers' weights; fp32 for the GroupNorm and LayerNorm params, the
        time-embed MLP and cc_projection, as they run in fp32 in the
        reference."""
        keep = {id(p) for p in self.time_embed.parameters()} | {id(p) for p in self.cc_projection.parameters()}
        for m in self.modules():
            if isinstance(m, (GroupNorm32, LayerNormFp32)):
                keep |= {id(p) for p in m.parameters(recurse=False)}
        return {n: torch.float32 if id(p) in keep else self.cfg.dtype for n, p in self.named_parameters()}

    def cast_for_inference(self):
        """Cast every parameter to its compute dtype (compute_dtypes) once."""
        dts = self.compute_dtypes()
        for n, p in self.named_parameters():
            p.data = p.data.to(dts[n])
        return self

    # ------------------------------------------------------------- VAE / CLIP
    def encode_images(self, images):
        """[0, 1] NHWC -> scaled latents (fp32)."""
        return self.vae.encode_mode(normalize(images)).float() * self.cfg.z_scale_factor

    def decode_latents(self, z):
        """latents -> [0, 1] NHWC images (fp32)."""
        return unnormalize(self.vae.decode(z / self.cfg.z_scale_factor).float())

    def decode_latents_chunked(self, z, max_batch: int = 8):
        """decode_latents in chunks of at most max_batch views, bounding the
        VAE decoder's activation memory (the reference declares
        vae_max_batch=8). The last chunk runs short; the reference pads it
        with zeros, which gives the same views."""
        return torch.cat([self.decode_latents(c) for c in torch.split(z, max_batch)])

    def embed_time(self, t):
        h = consumed(self.time_embed[0], self.time_embed[2], timestep_embedding(t, self.cfg.time_embed_dim))
        return self.time_embed[2](silu(h))

    def cc_proj(self, x):
        if not self.cfg.embed_camera_pose:
            return self.cc_projection(x)
        x = self.cc_projection[0](x)
        x = self.cc_projection[2](silu(x))
        return self.cc_projection[4](silu(x))

    # -------------------------------------------------------------- data prep
    def prepare_batch(self, images, R, T, f, c, input_idx, target_idx, depths=None, azimuth=None, elevation=None,
                      sp=None):
        """images (S, H, W, 3) in [0, 1]; cameras (S, ...); input_idx (1,),
        target_idx (B,) -> (batch_latents, batch_cameras, input_latents,
        input_cameras, clip_v_embed). azimuth and elevation (S,), in radians,
        are read by the legacy pose path only. `sp` (sp_views' pair): this
        rank encodes its slice of the targets, the latents gathered."""
        S, H, W, _ = images.shape
        B = target_idx.shape[0]
        ls = self.cfg.latent_size
        sel = torch.cat([input_idx, target_idx])
        if sp is None:
            latents = self.encode_images(images[sel])
        else:
            axis, cuts = sp
            own = self.encode_images(images[torch.cat([input_idx, target_idx[cuts[axis.rank]]])])
            latents = torch.cat([own[:1], gather_rows(own[1:], axis, [v.stop - v.start for v in cuts])])
        input_latents, batch_latents = latents[:1], latents[1:]
        if depths is not None:
            d = area_downsample(normalize(depths[sel]), H // ls)
        else:
            d = torch.zeros(1 + B, ls, ls, 1, device=images.device)
        input_latents = torch.cat([input_latents, torch.zeros_like(d[:1])], dim=-1)  # input depth zeroed
        batch_latents = torch.cat([batch_latents, d[1:]], dim=-1)

        cams = relative_cameras(make_cameras(R, T, f, c, device=images.device), input_idx)
        input_cameras = camera_slice(cams, input_idx)
        batch_cameras = camera_slice(cams, target_idx)

        clip_embed = self.clip_image_encoder(images[input_idx]).expand(B, 1, -1)

        if self.cfg.embed_camera_pose:
            def cam_vec(cc: Cameras):  # R 9 + T 3 + f 2
                return torch.cat([cc.R.reshape(len(cc), 1, 9), cc.T[:, None, :], cc.focal_length[:, None, :]], -1)

            cam_embed = torch.cat([cam_vec(input_cameras).expand(B, 1, 14), cam_vec(batch_cameras)], dim=-1)
        else:
            # the legacy zero123 delta pose (viewfusion:261-270); the
            # reference negates the elevations before the difference
            if azimuth is None or elevation is None:
                raise ValueError("embed_camera_pose=False: prepare_batch needs azimuth= and elevation=")
            d_a = azimuth[target_idx] - azimuth[input_idx]
            d_e = (-elevation[target_idx]) - (-elevation[input_idx])
            cam_embed = torch.stack([d_e, torch.sin(d_a), torch.cos(d_a), torch.zeros_like(d_a)], -1)[:, None, :]
        clip_v_embed = torch.cat([clip_embed, cam_embed], dim=-1)
        return batch_latents, batch_cameras, input_latents, input_cameras, clip_v_embed

    # -------------------------------------------------------------- the model
    def _unet_inputs(self, noisy_latents, input_latents, frustum):
        """Concat conditioning with the zero123 quirk: the RGB latent channels
        are divided by the VAE scale factor, the depth channel is not."""
        B = noisy_latents.shape[0]
        xc = input_latents.expand(B, *input_latents.shape[1:])
        xc = torch.cat([xc[..., :4] / self.cfg.z_scale_factor, xc[..., 4:]], dim=-1)
        x = torch.cat([noisy_latents, xc], dim=-1)
        levels = volume_pyramid(frustum.to(self.cfg.dtype), len(self.cfg.unet_channel_mult))
        return x, levels

    def _frustum(self, noisy_latents, batch_cameras, input_latents, input_cameras, t, t_embed, jitter_noise,
                 prev_depth, views=None):
        B = noisy_latents.shape[0]
        frustum = self.view_attn(
            noisy_latents, batch_cameras, torch.ones(B, device=noisy_latents.device), t_embed, t,
            self.sched(noisy_latents.device), input_latents, input_cameras, jitter_noise,
            overwrite_attn_depth=prev_depth, fuse_mode=self.cfg.fuse_mode, views=views,
        )
        return torch.zeros_like(frustum) if self.cfg.ablate_frustum else frustum

    def _unet(self, x, t, ctx, levels):
        return self.unet(x, t, ctx, levels, fuse_mode=self.cfg.fuse_mode, remat=self.cfg.unet_remat)

    def apply_model(self, noisy_latents, batch_cameras, input_latents, input_cameras, clip_v_embed, t,
                    jitter_noise, prev_depth=None, drop=None, views=None):
        """One conditional pass (training, or CFG 1). `drop` (B,), a uniform
        draw in [0, 1), applies the per-sample condition dropout where
        cfg.drop_conditions: four disjoint 5% bands drop the CLIP context
        (0.15, 0.2], the frustum (0.1, 0.15], the concat latents (0.05, 0.1]
        and all three [0, 0.05]. `views` (a slice of the B views) predicts
        those views only, GridAttn still reading all B views' latents."""
        t_embed = self.embed_time(t)
        frustum = self._frustum(noisy_latents, batch_cameras, input_latents, input_cameras, t, t_embed,
                                jitter_noise, prev_depth, views)
        if views is not None:
            noisy_latents, clip_v_embed, t = noisy_latents[views], clip_v_embed[views], t[views]
            drop = None if drop is None else drop[views]
        clip_embed = self.cc_proj(clip_v_embed)
        x, levels = self._unet_inputs(noisy_latents, input_latents, frustum)
        if drop is not None and self.cfg.drop_conditions:
            drop_all = drop <= 0.05
            keep = lambda lo, hi: 1.0 - (((drop > lo) & (drop <= hi)) | drop_all).float()
            clip_embed = clip_embed * keep(0.15, 0.2)[:, None, None]
            kv = keep(0.1, 0.15)[:, None, None, None, None]
            levels = [v * kv.to(v.dtype) for v in levels]
            x = torch.cat([x[..., :5], x[..., 5:] * keep(0.05, 0.1)[:, None, None, None]], dim=-1)
        return self._unet(x, t, clip_embed, levels)

    def apply_model_cfg(self, noisy_latents, batch_cameras, input_latents, input_cameras, clip_v_embed, t,
                        cfg_scale, jitter_noise, prev_depth=None):
        """Classifier-free-guided noise prediction; the null condition (zero
        clip, zero concat, zero frustum) rides the same 2B UNet batch.
        `prev_depth` (B, H, W, 1), if given, replaces GridAttn's depth
        estimate (feed_prev_depth)."""
        return self.apply_model_cfg_scenes(
            noisy_latents[None], [batch_cameras], [input_latents], [input_cameras], clip_v_embed[None], t, cfg_scale,
            jitter_noise[None], None if prev_depth is None else prev_depth[None])[0]

    def apply_model_cfg_scenes(self, noisy_latents, batch_cameras, input_latents, input_cameras, clip_v_embed, t,
                               cfg_scale, jitter_noise, prev_depth=None):
        """apply_model_cfg over N scenes at one timestep t (B,): noisy
        latents, clip_v_embed, jitter_noise and prev_depth with a leading
        scene axis N, the cameras and input latents as lists of N. GridAttn
        runs once a scene (it attends across one scene's views); the UNet
        runs once over the 2NB batch [conditional of every scene | null of
        every scene]."""
        N, B = noisy_latents.shape[:2]
        one = lambda ts: ts[0] if N == 1 else torch.cat(ts)
        t_embed = self.embed_time(t)
        frustum = one([
            self._frustum(noisy_latents[n], batch_cameras[n], input_latents[n], input_cameras[n], t, t_embed,
                          jitter_noise[n], None if prev_depth is None else prev_depth[n])
            for n in range(N)
        ])
        noisy = noisy_latents.reshape(N * B, *noisy_latents.shape[2:])
        clip_embed = self.cc_proj(clip_v_embed.reshape(N * B, *clip_v_embed.shape[2:]))
        x_cond, levels = self._unet_inputs(noisy, one([x.expand(B, *x.shape[1:]) for x in input_latents]), frustum)
        x_null = torch.cat([noisy, torch.zeros_like(x_cond[..., 5:])], dim=-1)
        x2 = torch.cat([x_cond, x_null], dim=0)
        ctx2 = torch.cat([clip_embed, torch.zeros_like(clip_embed)], dim=0)
        levels2 = [torch.cat([v, torch.zeros_like(v)], dim=0) for v in levels]
        pred = self._unet(x2, t.repeat(2 * N), ctx2, levels2)
        s, s_uc = pred[: N * B], pred[N * B :]
        return (s_uc + cfg_scale * (s - s_uc)).reshape(N, B, *pred.shape[1:])

    # -------------------------------------------------------------- training
    def loss_draws(self, B: int, device, generator=None) -> dict:
        """One p_losses call's random draws from `generator`: the shared
        timestep t (B,), the noise (B, ls, ls, 5), GridAttn's jitter (B, ls,
        ls, D) and the condition-dropout draw (B,)."""
        ls, D = self.cfg.latent_size, self.cfg.n_pts_per_ray
        t0 = torch.randint(0, self.cfg.timesteps, (1,), generator=generator, device=device)
        return dict(t=t0.expand(B), noise=torch.randn(B, ls, ls, 5, generator=generator, device=device),
                    jitter_noise=torch.randn(B, ls, ls, D, generator=generator, device=device),
                    drop=torch.rand(B, generator=generator, device=device))

    def p_losses(self, images, R, T, f, c, input_idx, target_idx, depths=None, feed_prev_depth=None,
                 generator=None, t=None, noise=None, jitter_noise=None, drop=None):
        """The shared-t L2 loss on cfg.objective for one scene (images (S, H,
        W, 3) in [0, 1], cameras (S, ...), input_idx (1,), target_idx (B,)).
        The encodes run without a gradient (VAE and CLIP are frozen). t,
        noise, jitter_noise and drop (loss_draws' keys) are drawn from
        `generator` where not given. feed_prev_depth (default cfg's) feeds
        GridAttn the input latent's depth channel instead of its estimate."""
        if self.cfg.loss_type != "l2":
            raise NotImplementedError(f"loss_type {self.cfg.loss_type!r}: only 'l2' exists, as in the reference")
        if self.cfg.objective not in ("noise", "x_start"):
            raise NotImplementedError(f"objective {self.cfg.objective!r}: 'noise' or 'x_start', as in the reference")
        if feed_prev_depth is None:
            feed_prev_depth = self.cfg.feed_prev_depth
        sp = self.sp_views(target_idx.shape[0])
        with torch.no_grad():
            batch_latents, batch_cams, input_latents, input_cams, clip_v = self.prepare_batch(
                images, R, T, f, c, input_idx, target_idx, depths=depths, sp=sp)
        B = batch_latents.shape[0]
        given = dict(t=t, noise=noise, jitter_noise=jitter_noise, drop=drop)
        if any(v is None for v in given.values()):
            draws = self.loss_draws(B, batch_latents.device, generator)
            given = {k: draws[k] if v is None else v for k, v in given.items()}
        t, noise = given["t"], given["noise"]
        noisy = q_sample(self.sched(batch_latents.device), batch_latents, t, noise)
        prev_depth = input_latents[..., 4:5].expand_as(noisy[..., 4:5]) if feed_prev_depth else None
        mine = None if sp is None else sp[1][sp[0].rank]
        pred = self.apply_model(noisy, batch_cams, input_latents, input_cams, clip_v, t, given["jitter_noise"],
                                prev_depth=prev_depth, drop=given["drop"], views=mine)
        target = noise if self.cfg.objective == "noise" else batch_latents
        if sp is None:
            return torch.mean((target - pred) ** 2)
        return torch.sum((target[mine] - pred) ** 2) * (sp[0].size / target.numel())


def randomize_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Replace every parameter with seeded random values (no zero-inits, so
    every path carries signal): matrices and kernels ~ N(0, 1 / fan_in),
    norm scales ~ 1 + N(0, 0.1^2), everything else ~ N(0, 0.02^2). The draw
    runs on the parameters' device from a torch.Generator there."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    norm_scales = {
        id(m.weight) for m in model.modules()
        if type(m).__name__ in ("GroupNorm32", "LayerNormFp32") and m.weight is not None
    }
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g, device=dev, dtype=torch.float32)
            if id(p) in norm_scales:
                p.copy_(1.0 + 0.1 * r)
            elif p.ndim >= 2 and "embedding" not in name:
                fan_in = p.shape[0] if name.endswith("visual.proj") else p[0].numel()
                p.copy_(r / fan_in**0.5)
            else:
                p.copy_(0.02 * r)
    return model
