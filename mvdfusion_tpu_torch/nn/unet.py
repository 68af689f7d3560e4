"""The MVD-Fusion UNet: the SD-v1 backbone plus grafted view-aligned attention
(torch counterpart of mvdfusion_tpu/nn/unet.py), NHWC activations.

Module and parameter names follow the reference checkpoint (openaimodel's
input_blocks / middle_block / output_blocks, ResBlock in_layers / emb_layers /
out_layers, SpatialTransformer, and the ViewAlignedFeatureTransformer's
aligned_attn_* names), i.e. the torch keys of convert/mapping.py's
unet_mapping. The transformer sites take the form of ops/block.py that the
reference takes (block_route): by default K3 at the 32^2 and 16^2 sites and
the module path at the C=1280 sites; under MVDF_BLOCK_SINGLE=1 K5 at 32^2,
under MVDF_BLOCK_BIGC=1 K6 at the C=1280 sites with 64 <= N <= 256; every
site on the module path under fuse_mode "never" (the default train step) or
the kernel-off switch. On the card a site's kernels read its weights
prepared once (ops/block.py::prepared_site_weights, kept on the site's
module until a parameter changes; its gradient reaches the parameters
through the plain version's backward); on the CPU the plain versions read
the parameters as they are. `remat` recomputes each block's interior in the
backward (torch.utils.checkpoint per ResBlock and site), keeping only the
blocks' boundaries.
The up-path skip joins are concatenations: the reference's split-skip form
computes the same function piece by piece for the TPU's layouts.

The same UNet runs MVDream's MultiViewUNetModel (SD-2.1-base,
mvdream/ldm/modules/diffusionmodules/openaimodel.py) under its options:
heads of `num_head_channels` channels, Linear proj_in / proj_out
(`use_linear_in_transformer`), no ViewAligned sites (`view_aligned`
False), a camera MLP added to the time embedding (`camera_dim`), and
attn1 over the `num_frames` views of a group joined into one sequence
(BasicTransformerBlock3D; each call a `model.mvattn` span of
utils/trace.py). Such sites have a 77-token attn2 and take the module path.

Under tensor parallelism (parallel/mesh.py) the ResBlocks' convs and
emb_layers, the time embedding and the C=1280 sites' attention and
FeedForward run split (nn/layers.py); a split conv's output is gathered so
that K1 sees whole maps. The sites that take a kernel read their weights
whole: at C <= 768 the layout keeps them whole, and K6 at the C=1280 sites
reads them gathered into its prepared weights.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mvdfusion_tpu_torch.nn.layers import (
    Conv1x1,
    Conv2d,
    CrossAttention,
    FeedForward,
    GroupNorm32,
    LayerNormFp32,
    Linear,
    consumed,
    silu,
    timestep_embedding,
)
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.block import BlockWeights, block_route, prepared_site_weights, transformer_block
from mvdfusion_tpu_torch.ops.image import area_downsample, nearest_upsample2x
from mvdfusion_tpu_torch.parallel.tensor import full_param
from mvdfusion_tpu_torch.utils.trace import span


class ResBlock(nn.Module):
    """GN+SiLU -> conv3x3 -> + emb row -> GN+SiLU -> conv3x3 (+ 1x1 skip)."""

    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(cin, act="silu"), nn.Identity(), Conv2d(cin, cout, 3, padding=1)])
        self.emb_layers = nn.ModuleList([nn.Identity(), Linear(emb_dim, cout)])
        self.out_layers = nn.ModuleList(
            [GroupNorm32(cout, act="silu"), nn.Identity(), nn.Identity(), Conv2d(cout, cout, 3, padding=1)]
        )
        self.skip_connection = Conv1x1(cin, cout) if cin != cout else None

    def forward(self, x, emb):
        h = self.in_layers[2](self.in_layers[0](x))
        e = self.emb_layers[1](silu(emb))
        h = h + e[:, None, None, :].to(h.dtype)
        h = self.out_layers[3](self.out_layers[0](h))
        skip = self.skip_connection(x) if self.skip_connection is not None else x
        return skip + h


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention to the context, GEGLU FF. With
    num_frames F > 1, attn1 attends over the F views of each group of F
    consecutive batch rows joined into one sequence (MVDream's
    BasicTransformerBlock3D); attn2 and the FF stay per view."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int, num_frames: int = 1):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNormFp32(dim)
        self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)
        self.num_frames = num_frames

    def forward(self, x, context):
        """x (B, N, C); context (B, M, Cc), or (B*N, D, Cc) per pixel."""
        frames = self.num_frames
        if frames > 1:
            B, N, C = x.shape
            with span("model.mvattn"):
                x = x + self.attn1(self.norm1(x).reshape(B // frames, frames * N, C)).reshape(B, N, C)
        else:
            x = x + self.attn1(self.norm1(x))
        q = self.norm2(x)
        if context.shape[0] != x.shape[0]:  # per-pixel frustum: fold N into batch
            B, N, C = x.shape
            x = x + self.attn2(q.reshape(B * N, 1, C), context).reshape(B, N, C)
        else:
            x = x + self.attn2(q, context)
        return x + self.ff(self.norm3(x))


def _attn2_contribution(block: BasicTransformerBlock, ctx):
    """to_out(to_v(ctx)): attn2's exact output for a 1-key context.
    ctx (B, Cc) -> (B, C) or (B, N, Cc) -> (B, N, C)."""
    return block.attn2.one_key(ctx)


def _site_form(blocks, one_key: bool, B: int, N: int, C: int, heads: int, fuse_mode: str):
    """The kernel form of a site with one per-view transformer block and a
    1-key attn2 context under fuse_mode "auto", or None for the module
    path."""
    if fuse_mode == "never" or len(blocks) != 1 or not one_key or blocks[0].num_frames != 1:
        return None
    return block_route(B, N, C, heads, blocks[0].ff.net[2].in_features)


def _site_params(norm, proj_in, proj_out, block: BasicTransformerBlock) -> tuple:
    """Every parameter a kernel site reads, in BlockWeights order with
    attn1's q, k and v weights apart."""
    a1, ff = block.attn1, block.ff
    return (norm.weight, norm.bias, proj_in.weight, proj_in.bias, block.norm1.weight, block.norm1.bias,
            a1.to_q.weight, a1.to_k.weight, a1.to_v.weight, a1.to_out[0].weight, a1.to_out[0].bias,
            block.norm3.weight, block.norm3.bias, ff.net[0].proj.weight, ff.net[0].proj.bias,
            ff.net[2].weight, ff.net[2].bias, proj_out.weight, proj_out.bias)


def _site_weights(p: tuple) -> BlockWeights:
    """_site_params as BlockWeights: the 1x1 convs' kernels as matrices, qkv
    concatenated."""
    mat = lambda w: w.reshape(w.shape[0], -1)  # Linear or 1x1 conv
    return BlockWeights(p[0], p[1], mat(p[2]), p[3], p[4], p[5], torch.cat(p[6:9], dim=0), *p[9:17], mat(p[17]),
                        p[18])


def _kernel_site(module, x, a2, params, dt, form):
    """A site on its kernel form: x (B, H, W, C) -> (B, H, W, C). Where the
    kernels read the prepared weights and a gradient is wanted, the
    parameters go along as they are for the backward. Split parameters are
    gathered whole (into the prepared weights, once a version)."""
    B, H, W, C = x.shape
    whole = lambda: tuple(full_param(p) for p in params)
    prepared = None
    if _lib.reads_prepared(x):
        prepared = prepared_site_weights(module, params, lambda: _site_weights(whole()), dt)
    w = _site_weights(whole()) if prepared is None or _lib.needs_grad(x, a2, params) else prepared
    return transformer_block(x.reshape(B, H * W, C).to(dt), a2, w, module.heads, form,
                             prepared).reshape(B, H, W, C)


class SpatialTransformer(nn.Module):
    """GN(eps 1e-6) -> proj_in -> transformer blocks -> proj_out + x; the
    projections 1x1 convs, or Linear layers where `use_linear`."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int, context_dim: int, use_linear: bool = False,
                 num_frames: int = 1):
        super().__init__()
        inner = heads * dim_head
        proj = Linear if use_linear else Conv1x1
        self.heads = heads
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = proj(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim, num_frames) for _ in range(depth)]
        )
        self.proj_out = proj(inner, ch)

    def forward(self, x, context, fuse_mode: str = "auto"):
        B, H, W, C = x.shape
        blk = self.transformer_blocks
        form = _site_form(blk, context.shape[1] == 1, B, H * W, C, self.heads, fuse_mode)
        if form:
            a2 = _attn2_contribution(blk[0], context[:, 0])
            params = _site_params(self.norm, self.proj_in, self.proj_out, blk[0])
            return _kernel_site(self, x, a2, params, self.proj_in.weight.dtype, form)
        h = self.proj_in(self.norm(x)).reshape(B, H * W, -1)
        for b in blk:
            h = b(h, context)
        return self.proj_out(h.reshape(B, H, W, -1)) + x


class ViewAlignedFeatureTransformer(nn.Module):
    """The grafted site (use_linear=True): each pixel cross-attends to its D
    view-aligned frustum features."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.aligned_attn_norm = GroupNorm32(ch, eps=1e-6)
        self.aligned_attn_proj_in = Linear(ch, inner)
        self.aligned_attn_transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)]
        )
        self.aligned_attn_proj_out = Linear(inner, ch)

    def forward(self, x, volume, fuse_mode: str = "auto"):
        """x (B, H, W, C); volume (B, H, W, D, Cc)."""
        B, H, W, C = x.shape
        D, Cc = volume.shape[3], volume.shape[4]
        blk = self.aligned_attn_transformer_blocks
        form = _site_form(blk, D == 1, B, H * W, C, self.heads, fuse_mode)
        if form:
            a2 = _attn2_contribution(blk[0], volume.reshape(B, H * W, Cc))
            params = _site_params(self.aligned_attn_norm, self.aligned_attn_proj_in, self.aligned_attn_proj_out,
                                  blk[0])
            return _kernel_site(self, x, a2, params, self.aligned_attn_proj_in.weight.dtype, form)
        ctx = volume.reshape(B * H * W, D, Cc)
        h = self.aligned_attn_proj_in(self.aligned_attn_norm(x).reshape(B, H * W, C))
        for b in blk:
            h = b(h, ctx)
        return self.aligned_attn_proj_out(h).reshape(B, H, W, C) + x


class Downsample(nn.Module):
    """Stride-2 3x3 conv, symmetric padding 1 (torch Conv2d semantics)."""

    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_upsample2x(x))


def volume_pyramid(volume: torch.Tensor, num_levels: int) -> list:
    """Area-downsample the (B, H, W, D, C) frustum to each UNet resolution,
    each level from the previous one."""
    B, H, W, D, C = volume.shape
    levels = [volume.reshape(B, H, W, D * C)]
    for _ in range(num_levels - 1):
        levels.append(area_downsample(levels[-1], 2))
    return [lv.reshape(B, H // 2**i, W // 2**i, D, C) for i, lv in enumerate(levels)]


class UNetModel(nn.Module):
    """forward(x (B,H,W,Cin), t (B,), context (B,M,ctx), volume_levels,
    fuse_mode, remat, camera) -> (B, H, W, Cout) fp32.

    The defaults build MVD-Fusion's UNet. `num_head_channels` > 0 gives
    each site ch // num_head_channels heads of that width (else num_heads
    heads); `use_linear_in_transformer` Linear site projections;
    `view_aligned` False leaves out the ViewAligned sites; `camera_dim`
    adds camera_embed (Linear, SiLU, Linear) of a (B, camera_dim) camera
    to the time embedding; `num_frames` joins that many consecutive views
    in each site's attn1."""

    def __init__(
        self,
        in_channels: int = 10,
        model_channels: int = 320,
        out_channels: int = 5,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        transformer_depth: int = 1,
        context_dim: int = 768,
        num_head_channels: int = -1,
        use_linear_in_transformer: bool = False,
        view_aligned: bool = True,
        camera_dim: int | None = None,
        num_frames: int = 1,
    ):
        super().__init__()
        mc = model_channels
        emb = mc * 4
        self.model_channels = mc
        self.time_embed = nn.ModuleList([Linear(mc, emb), nn.Identity(), Linear(emb, emb)])
        if camera_dim is not None:
            self.camera_embed = nn.ModuleList([Linear(camera_dim, emb), nn.Identity(), Linear(emb, emb)])
        attn = set(attention_resolutions)

        def site(cls, ch):
            heads = ch // num_head_channels if num_head_channels > 0 else num_heads
            if cls is ViewAlignedFeatureTransformer:
                return cls(ch, heads, ch // heads, transformer_depth, context_dim)
            return cls(ch, heads, ch // heads, transformer_depth, context_dim, use_linear_in_transformer, num_frames)

        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb)]
                ch = mult * mc
                if ds in attn:
                    layers.append(site(SpatialTransformer, ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        middle = [ResBlock(ch, ch, emb), site(SpatialTransformer, ch)]
        if view_aligned:
            middle.append(site(ViewAlignedFeatureTransformer, ch))
        self.middle_block = nn.ModuleList(middle + [ResBlock(ch, ch, emb)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb)]
                ch = mult * mc
                if ds in attn:
                    layers.append(site(SpatialTransformer, ch))
                    if view_aligned:
                        layers.append(site(ViewAlignedFeatureTransformer, ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([GroupNorm32(ch, act="silu"), nn.Identity(), Conv2d(ch, out_channels, 3, padding=1)])

    def forward(self, x, t, context, volume_levels=(), fuse_mode: str = "auto", remat: bool = False, camera=None):
        dt = self.out[2].weight.dtype
        emb = consumed(self.time_embed[0], self.time_embed[2], timestep_embedding(t, self.model_channels))
        emb = self.time_embed[2](silu(emb))
        if camera is not None:
            cam = consumed(self.camera_embed[0], self.camera_embed[2], camera)
            emb = emb + self.camera_embed[2](silu(cam))
        x = x.to(dt)
        context = context.to(dt)
        levels = {lv.shape[1]: lv.to(dt) for lv in volume_levels}

        remat = remat and torch.is_grad_enabled()

        def block(m, *args):
            return checkpoint(m, *args, use_reentrant=False) if remat else m(*args)

        def run(layers, h):
            for m in layers:
                if isinstance(m, ResBlock):
                    h = block(m, h, emb)
                elif isinstance(m, SpatialTransformer):
                    h = block(m, h, context, fuse_mode)
                elif isinstance(m, ViewAlignedFeatureTransformer):
                    h = block(m, h, levels[h.shape[1]], fuse_mode)
                else:
                    h = m(h)
            return h

        hs = []
        h = x
        for layers in self.input_blocks:
            h = run(layers, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for layers in self.output_blocks:
            h = run(layers, torch.cat([h, hs.pop()], dim=-1))
        return self.out[2](self.out[0](h)).float()
