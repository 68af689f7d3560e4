"""The plain reference of MVD-Fusion's inference path, in float32 PyTorch.

An independent replica of the reference model's documented semantics and
state-dict names (mvdfusion/unet.py, mvdfusion/attention.py,
mvdfusion/view_attn_efficient2.py, the SD1 ldm blocks,
viewfusion_zero_depth_rgb.py, mvdfusion/sampler.py), frozen from the repo's
test replica (tests/torch_ref.py) and widened to every size of a
configuration. It imports nothing of the program under test and uses no
kernel: every product is an nn.Linear, nn.Conv2d or a plain matmul, every
attention an explicit softmax. Modules are NCHW; the pipeline functions at
the bottom take and return NHWC tensors as the program's entries do.

`fake_quantize_` turns a built reference into the control: every Linear and
Conv2d computes on weights and inputs rounded to float8 e4m3 with a
per-tensor scale, the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@contextlib.contextmanager
def float32_products():
    """Products in true float32 inside the block: no TF32 in matmuls or
    cuDNN convolutions (the program's own settings are restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def attention(q, k, v):
    """q (B, h, N, d), k/v (B, h, M, d) -> (B, h, N, d), explicit softmax."""
    w = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5, dim=-1)
    return w @ v


# ----------------------------------------------------------------- LDM blocks
class GEGLUProj(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.Sequential(GEGLUProj(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    """Biasless q, k, v; to_out.0 with bias."""

    def __init__(self, query_dim, context_dim, heads, dim_head):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None):
        context = x if context is None else context
        B, N, _ = x.shape
        M = context.shape[1]
        h = self.heads
        q = self.to_q(x).view(B, N, h, -1).transpose(1, 2)
        k = self.to_k(context).view(B, M, h, -1).transpose(1, 2)
        v = self.to_v(context).view(B, M, h, -1).transpose(1, 2)
        return self.to_out(attention(q, k, v).transpose(1, 2).reshape(B, N, -1))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """1x1-conv projections (use_linear=False)."""

    def __init__(self, ch, heads, dim_head, depth, context_dim):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Conv2d(ch, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Conv2d(inner, ch, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return self.proj_out(y.transpose(1, 2).reshape(b, -1, h, w)) + x


class DualAttentionBlock(nn.Module):
    """Per-view self-attention over HW tokens, then one query a pixel against
    the D frustum samples of that pixel, then the GEGLU FeedForward."""

    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context, shape):
        b, c, h, w = shape
        x = self.attn1(self.norm1(x)) + x
        x = x.reshape(b * h * w, 1, -1)
        context = context.reshape(b * h * w, context.shape[2], context.shape[3])
        x = self.attn2(self.norm2(x), context) + x
        x = x[:, 0].reshape(b, h * w, -1)
        return self.ff(self.norm3(x)) + x


class ViewAlignedFeatureTransformer(nn.Module):
    def __init__(self, ch, heads, dim_head, depth, context_dim):
        super().__init__()
        inner = heads * dim_head
        self.aligned_attn_norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.aligned_attn_proj_in = nn.Linear(ch, inner)
        self.aligned_attn_transformer_blocks = nn.ModuleList(
            [DualAttentionBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.aligned_attn_proj_out = nn.Linear(ch, inner)

    def forward(self, x, volume):
        b, c, h, w = x.shape
        ctx = volume.reshape(b, h * w, volume.shape[3], volume.shape[4])  # (B, HW, D, C)
        y = self.aligned_attn_proj_in(self.aligned_attn_norm(x).flatten(2).transpose(1, 2))
        for blk in self.aligned_attn_transformer_blocks:
            y = blk(y, ctx, x.shape)
        return self.aligned_attn_proj_out(y).transpose(1, 2).reshape(b, c, h, w) + x


class ResBlock(nn.Module):
    def __init__(self, cin, emb_dim, cout):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(32, cin), nn.SiLU(), nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, cout))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, cout), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Seq(nn.Sequential):
    def forward(self, x, emb, context, levels):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            elif isinstance(layer, ViewAlignedFeatureTransformer):
                x = layer(x, levels[x.shape[-1]])
            else:
                x = layer(x)
        return x


def timestep_embedding(t, dim, max_period=10000):
    """SD sinusoidal embedding, [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1) if dim % 2 else emb


class UNetModel(nn.Module):
    """The SD1 UNet with the ViewAligned layers grafted in at the middle block
    and after each attention site of the output blocks."""

    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks, attention_resolutions,
                 channel_mult, num_heads, transformer_depth, context_dim):
        super().__init__()
        mc = model_channels
        ted = mc * 4
        self.model_channels = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        site = lambda cls, ch: cls(ch, num_heads, ch // num_heads, transformer_depth, context_dim)
        self.input_blocks = nn.ModuleList([Seq(nn.Conv2d(in_channels, mc, 3, padding=1))])
        ch, ds, chans = mc, 1, [mc]
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, ted, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(site(SpatialTransformer, ch))
                self.input_blocks.append(Seq(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Seq(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = Seq(ResBlock(ch, ted, ch), site(SpatialTransformer, ch),
                                site(ViewAlignedFeatureTransformer, ch), ResBlock(ch, ted, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), ted, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers += [site(SpatialTransformer, ch), site(ViewAlignedFeatureTransformer, ch)]
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Seq(*layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(), nn.Conv2d(mc, out_channels, 3, padding=1))

    def forward(self, x, t, context, levels):
        """x (B, Cin, H, W); levels: {width: (B, w, w, D, C)}."""
        emb = self.time_embed(timestep_embedding(t, self.model_channels))
        hs, h = [], x
        for blk in self.input_blocks:
            h = blk(h, emb, context, levels)
            hs.append(h)
        h = self.middle_block(h, emb, context, levels)
        for blk in self.output_blocks:
            h = blk(torch.cat([h, hs.pop()], dim=1), emb, context, levels)
        return self.out(h)


# -------------------------------------------------------------------- GridAttn
def harmonic_embed(x, n_harmonic=7, omega0=0.1):
    freqs = (2.0 ** torch.arange(n_harmonic, dtype=torch.float32, device=x.device)) * omega0
    xf = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([xf.sin(), xf.cos(), x], dim=-1)


class Cams(NamedTuple):
    """PyTorch3D convention: X_view = X_world @ R + T; NDC with +x left."""

    R: torch.Tensor
    T: torch.Tensor
    f: torch.Tensor
    c: torch.Tensor


def camera_center(cams):
    return -torch.einsum("bj,bkj->bk", cams.T, cams.R)


def transform_points_ndc(cams, pts):
    """World points (1 or B, N, 3) -> (B, N, 3) = (x_ndc, y_ndc, 1/z)."""
    if pts.shape[0] == 1 and cams.R.shape[0] != 1:
        pts = pts.expand(cams.R.shape[0], -1, -1)
    xv = torch.einsum("bnj,bjk->bnk", pts, cams.R) + cams.T[:, None]
    z = xv[..., 2:3]
    return torch.cat([cams.f[:, None] * xv[..., :2] / z + cams.c[:, None], 1.0 / z], dim=-1)


def unproject_points(cams, xy_depth):
    z = xy_depth[..., 2:3]
    xy_view = (xy_depth[..., :2] - cams.c[:, None]) * z / cams.f[:, None]
    return torch.einsum("bnj,bkj->bnk", torch.cat([xy_view, z], -1) - cams.T[:, None], cams.R)


def pixel_rays(cams, H, W):
    """Rays through the pixel centres of an H x W NDC grid (+x left, +y up):
    origins on the z = 1 plane minus one direction, directions to z = 2."""
    dev = cams.R.device
    xs = torch.linspace(1.0 - 1.0 / W, -1.0 + 1.0 / W, W, device=dev)
    ys = torch.linspace(1.0 - 1.0 / H, -1.0 + 1.0 / H, H, device=dev)
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    B = cams.R.shape[0]
    xy = torch.stack([x, y], -1).reshape(1, H * W, 2).expand(B, -1, -1)
    one = torch.ones_like(xy[..., :1])
    p1 = unproject_points(cams, torch.cat([xy, one], -1))
    p2 = unproject_points(cams, torch.cat([xy, 2 * one], -1))
    dirs = p2 - p1
    return (p1 - dirs).reshape(B, H, W, 3), dirs.reshape(B, H, W, 3)


class TimmAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(attention(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(B, N, C))


class TimmMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DiTBlock(nn.Module):
    """adaLN-Zero block (view_attn_efficient2.py:42-67)."""

    def __init__(self, hidden, heads, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden, elementwise_affine=False, eps=1e-6)
        self.attn = TimmAttention(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden, elementwise_affine=False, eps=1e-6)
        self.mlp = TimmMlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))

    def forward(self, x, cond):
        sa, ca, ga, sm, cm, gm = (m.unsqueeze(1) for m in self.adaLN_modulation(cond).chunk(6, dim=1))
        x = x + ga * self.attn(self.norm1(x) * (1 + ca) + sa)
        return x + gm * self.mlp(self.norm2(x) * (1 + cm) + sm)


class AggregationTransformer(nn.Module):
    def __init__(self, hidden, num_layers, heads, mlp_ratio):
        super().__init__()
        self.layer_list = nn.ModuleList([DiTBlock(hidden, heads, mlp_ratio) for _ in range(num_layers)])
        self.weight_layer = nn.Linear(hidden, 1)

    def forward(self, x, cond):
        for layer in self.layer_list:
            x = layer(x, cond)
        return x, self.weight_layer(x)


class GridAttn(nn.Module):
    """Each target pixel's D depth samples, projected into every target view
    and the input view: per-view tokens of sampled features and ray
    harmonics, a DiT across the views, a softmax-weighted pool."""

    def __init__(self, in_channels, hidden, output_dim, heads, mlp_ratio, num_layers, n_pts_per_ray,
                 depth_scale=2.0, depth_shift=0.5):
        super().__init__()
        self.depth_scale, self.depth_shift, self.n_pts_per_ray = depth_scale, depth_shift, n_pts_per_ray
        self.z_embedder = nn.Sequential(nn.Linear(in_channels, hidden), nn.GELU())
        self.pre_layer_b = nn.Sequential(nn.Linear(hidden * 2 + 90 * 2 + 15 * 2 + 1, hidden), nn.GELU())
        self.aggregation_transformer = AggregationTransformer(hidden, num_layers, heads, mlp_ratio)
        self.final_layer_b = nn.Linear(hidden, output_dim)

    def forward(self, noisy, cams, t_embed, t, sqrt_acp, sqrt_1macp, in_lat, in_cams, jitter):
        """noisy (B, 5, H, W), in_lat (1, 5, H, W), jitter (B, D, H, W) ->
        frustum (B, H, W, D, C)."""
        B, _, H, W = noisy.shape
        D, V = self.n_pts_per_ray, B
        a = sqrt_acp[t]
        depth_std = (sqrt_1macp[t] / a / 10.0)[:, None, None, None]
        depth = (noisy[:, 4:5] / a[:, None, None, None]).expand(-1, D, -1, -1) + depth_std * jitter
        depth = torch.clamp((depth + 1.0) * 0.5, 0.0, 1.0) * self.depth_scale + self.depth_shift
        depth = depth.permute(0, 2, 3, 1)  # (B, H, W, D)
        origins, dirs = pixel_rays(cams, H, W)
        N = B * H * W * D
        pts = (origins[..., None, :] + dirs[..., None, :] * depth[..., None]).reshape(1, N, 3)
        feat = self.z_embedder(noisy.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        in_feat = self.z_embedder(in_lat.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

        def gsample(maps, xy):  # maps (V, C, H, W), xy (V, N, 2) in NDC (+x left): negated
            out = F.grid_sample(maps, -xy.unsqueeze(2), align_corners=True, mode="bilinear", padding_mode="border")
            return out[..., 0].permute(0, 2, 1)

        ref_feats = gsample(feat, transform_points_ndc(cams, pts)[..., :2])
        in_feats = gsample(in_feat, transform_points_ndc(in_cams, pts)[..., :2]).expand(V, -1, -1)
        centers = camera_center(cams)
        ref_dir = pts.expand(V, -1, -1) - centers[:, None]
        ref_depth = torch.linalg.norm(ref_dir, dim=-1, keepdim=True)
        ref_dir = F.normalize(ref_dir, dim=-1)
        ref_plucker = harmonic_embed(torch.cat([ref_dir, torch.cross(centers[:, None].expand_as(ref_dir), ref_dir,
                                                                     dim=-1)], -1))
        q_dir = F.normalize(dirs, dim=-1)[:, :, :, None, :].expand(B, H, W, D, 3).reshape(1, N, 3)
        q_origin = centers[:, None, None, None, :].expand(B, H, W, D, 3).reshape(1, N, 3)
        q_plucker = harmonic_embed(torch.cat([q_dir, torch.cross(q_origin, q_dir, dim=-1)], -1)).expand(V, -1, -1)
        q_depth = harmonic_embed(depth.reshape(1, N, 1)).expand(V, -1, -1)
        mask = torch.ones(V, N, 1, device=noisy.device)
        z = torch.cat([ref_feats, in_feats, ref_plucker, harmonic_embed(ref_depth), q_plucker, q_depth, mask], -1)
        tokens = self.pre_layer_b(z.transpose(0, 1))  # (N, V, hidden)
        out, w = self.aggregation_transformer(tokens, t_embed[:1])
        pooled = (out * torch.softmax(w, dim=-2)).sum(dim=-2)
        return self.final_layer_b(pooled).reshape(B, H, W, D, -1)


# ------------------------------------------------------------------------- VAE
def swish(x):
    return x * torch.sigmoid(x)


class VAEResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(swish(self.norm2(self.conv1(swish(self.norm1(x))))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class VAEAttnBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        h = self.norm(x)
        b, c, hh, ww = x.shape
        tok = lambda m: m(h).reshape(b, 1, c, hh * ww).transpose(-1, -2)  # one head of width c
        out = attention(tok(self.q), tok(self.k), tok(self.v))
        return x + self.proj_out(out.transpose(-1, -2).reshape(b, c, hh, ww))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()


class _Conv(nn.Module):
    def __init__(self, ch, down):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(ch, ch, 3, stride=2 if down else 1, padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _mid(ch):
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = VAEResnetBlock(ch, ch), VAEAttnBlock(ch), VAEResnetBlock(ch, ch)
    return mid


class VAEEncoder(nn.Module):
    def __init__(self, ch, ch_mult, nrb, z_ch):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in = ch
        for level, m in enumerate(ch_mult):
            lev = _Level()
            for _ in range(nrb):
                lev.block.append(VAEResnetBlock(block_in, ch * m))
                block_in = ch * m
            if level != len(ch_mult) - 1:
                lev.downsample = _Conv(block_in, down=True)
            self.down.append(lev)
        self.mid = _mid(block_in)
        self.norm_out = nn.GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, 2 * z_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for lev in self.down:
            for blk in lev.block:
                h = blk(h)
            if hasattr(lev, "downsample"):
                h = lev.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(swish(self.norm_out(h)))


class VAEDecoder(nn.Module):
    def __init__(self, ch, ch_mult, nrb, z_ch, out_ch=3):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_ch, block_in, 3, padding=1)
        self.mid = _mid(block_in)
        self.up = nn.ModuleList([_Level() for _ in ch_mult])
        for level in reversed(range(len(ch_mult))):
            lev = self.up[level]
            for _ in range(nrb + 1):
                lev.block.append(VAEResnetBlock(block_in, ch * ch_mult[level]))
                block_in = ch * ch_mult[level]
            if level != 0:
                lev.upsample = _Conv(block_in, down=False)
        self.norm_out = nn.GroupNorm(32, block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(range(len(self.up))):
            lev = self.up[level]
            for blk in lev.block:
                h = blk(h)
            if hasattr(lev, "upsample"):
                h = lev.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, embed_dim, ch, ch_mult, nrb, z_ch=4):
        super().__init__()
        self.encoder = VAEEncoder(ch, ch_mult, nrb, z_ch)
        self.decoder = VAEDecoder(ch, ch_mult, nrb, z_ch)
        self.quant_conv = nn.Conv2d(2 * z_ch, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_ch, 1)
        self.embed_dim = embed_dim


# ------------------------------------------------------------------------ CLIP
class CLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameter names, computed explicitly."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias).reshape(B, N, 3, self.heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        return self.out_proj(attention(q, k, v).transpose(1, 2).reshape(B, N, C))


class CLIPResblock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.attn = CLIPAttention(width, heads)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, width * 4), "c_proj": nn.Linear(width * 4, width)})
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        h = self.mlp["c_fc"](self.ln_2(x))
        return x + self.mlp["c_proj"](h * torch.sigmoid(1.702 * h))  # QuickGELU


class CLIPVisual(nn.Module):
    def __init__(self, width, layers, heads, output_dim, patch=14, image=224):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty((image // patch) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([CLIPResblock(width, heads) for _ in range(layers)])
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x):
        h = self.conv1(x).flatten(2).transpose(1, 2)
        B = h.shape[0]
        h = torch.cat([self.class_embedding[None, None].expand(B, 1, -1), h], dim=1) + self.positional_embedding[None]
        h = self.ln_pre(h)
        for blk in self.transformer.resblocks:
            h = blk(h)
        return self.ln_post(h[:, 0]) @ self.proj


class _Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


# ------------------------------------------------------------------ ViewFusion
class ViewFusion(nn.Module):
    """The reference checkpoint's layout (viewfusion_zero_depth_rgb.py) for
    the keys inference reads: view_attn, unet_model.unet_model, vae,
    clip_image_encoder.model.visual, cc_projection, time_embed."""

    def __init__(self, m: dict):
        super().__init__()
        self.m = m
        ctx = m["context_dim"]
        self.view_attn = GridAttn(5, m["viewattn_hidden"], ctx, m["viewattn_heads"], m["viewattn_mlp_ratio"],
                                  m["viewattn_layers"], m["n_pts_per_ray"])
        self.unet_model = _Holder(unet_model=UNetModel(
            m["unet_in_channels"], m["unet_model_channels"], m["unet_out_channels"], m["unet_num_res_blocks"],
            tuple(m["unet_attention_resolutions"]), tuple(m["unet_channel_mult"]), m["unet_num_heads"],
            m["unet_transformer_depth"], ctx))
        self.vae = AutoencoderKL(m["vae_embed_dim"], m["vae_ch"], tuple(m["vae_ch_mult"]), m["vae_num_res_blocks"])
        self.clip_image_encoder = _Holder(model=_Holder(visual=CLIPVisual(
            m["clip_width"], m["clip_layers"], m["clip_heads"], ctx)))
        self.cc_projection = nn.Sequential(nn.Linear(ctx + 28, ctx), nn.SiLU(), nn.Linear(ctx, ctx), nn.SiLU(),
                                           nn.Linear(ctx, ctx))
        ted = m["time_embed_dim"]
        self.time_embed = nn.Sequential(nn.Linear(ted, ted), nn.SiLU(), nn.Linear(ted, ted))

    @property
    def unet(self):
        return self.unet_model.unet_model


def norm_scale_names(model: nn.Module) -> set:
    """State-dict names of the GroupNorm and LayerNorm scales."""
    return {f"{n}.weight" for n, mod in model.named_modules()
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) and mod.weight is not None}


# ------------------------------------------------------------- fp8 control
def _fp8(x):
    """Round to float8 e4m3 under a per-tensor scale that maps max|x| to 448."""
    s = 448.0 / x.abs().amax().clamp(min=1e-12)
    return (x * s).to(torch.float8_e4m3fn).to(x.dtype) / s


def fake_quantize_(model: nn.Module) -> nn.Module:
    """Every Linear and Conv2d computes on fp8-rounded weights and inputs
    (CLIP's packed in-projection too); the rest stays in float32."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                mod.weight.copy_(_fp8(mod.weight))
                mod.register_forward_pre_hook(lambda _m, args: (_fp8(args[0]), *args[1:]))
            elif isinstance(mod, CLIPAttention):
                mod.in_proj_weight.copy_(_fp8(mod.in_proj_weight))
                mod.register_forward_pre_hook(lambda _m, args: (_fp8(args[0]), *args[1:]))
    return model


# -------------------------------------------------------------------- pipeline
def ddpm_tables(m: dict, device):
    betas = np.linspace(m["linear_start"] ** 0.5, m["linear_end"] ** 0.5, m["timesteps"], dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return abar, f32(np.sqrt(abar)), f32(np.sqrt(1.0 - abar))


def clip_preprocess(images):
    """(B, H, W, 3) in [0, 1] -> (B, 3, 224, 224): bicubic (A = -0.75,
    align_corners) to 224, then the reference's (x + 1) / 2 on [0, 1]
    input, then CLIP's mean and std."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(224, 224), mode="bicubic", align_corners=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def encode(ref: ViewFusion, images):
    """[0, 1] NHWC images -> scaled latents (B, 4, h, w)."""
    x = torch.clamp(images * 2.0 - 1.0, -1.0, 1.0).permute(0, 3, 1, 2)
    return ref.vae.quant_conv(ref.vae.encoder(x))[:, : ref.vae.embed_dim] * ref.m["z_scale_factor"]


def decode(ref: ViewFusion, z):
    """Latents NHWC (B, h, w, 4) -> [0, 1] images NHWC."""
    x = ref.vae.decoder(ref.vae.post_quant_conv(z.permute(0, 3, 1, 2) / ref.m["z_scale_factor"]))
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)


class Prepared(NamedTuple):
    batch_latents: torch.Tensor  # (B, 5, h, w), depth zero
    cams: Cams  # targets, relative to the input view
    in_lat: torch.Tensor  # (1, 5, h, w)
    in_cams: Cams
    clip_v: torch.Tensor  # (B, 1, ctx + 28)


def prepare(ref: ViewFusion, images, R, T, f, c, input_idx, target_idx) -> Prepared:
    """One scene: images (S, H, W, 3) in [0, 1], cameras (S, ...). The
    input and target views are VAE-encoded (depth channel zero), cameras
    made relative to the input view (R_i <- Rq^T R_i), the input image
    embedded by CLIP beside each target's 28-number camera vector."""
    B = target_idx.shape[0]
    sel = torch.cat([input_idx, target_idx])
    lat = encode(ref, images[sel])
    lat = torch.cat([lat, torch.zeros_like(lat[:, :1])], dim=1)
    Rq = R[input_idx][0]
    cams = Cams(torch.einsum("ji,bjk->bik", Rq, R), T, f, c)
    pick = lambda idx: Cams(*(a[idx] for a in cams))
    in_cams, tgt = pick(input_idx), pick(target_idx)
    clip = (ref.clip_image_encoder.model.visual(clip_preprocess(images[input_idx])))[:, None].expand(B, 1, -1)
    vec = lambda cc: torch.cat([cc.R.reshape(len(cc.R), 1, 9), cc.T[:, None], cc.f[:, None]], -1)
    clip_v = torch.cat([clip, vec(in_cams).expand(B, 1, 14), vec(tgt)], -1)
    return Prepared(lat[1:], tgt, lat[:1], in_cams, clip_v)


def apply_model_cfg(ref: ViewFusion, p: Prepared, x, t, jitter, scale, tables):
    """CFG noise prediction: a conditional and a null pass (zero CLIP
    context, zero concat latents, zero frustum) in one UNet batch, mixed
    s_uc + scale (s - s_uc). x (B, 5, h, w), jitter (B, D, h, w)."""
    m = ref.m
    _, sqrt_acp, sqrt_1macp = tables
    B, _, H, W = x.shape
    t_embed = ref.time_embed(timestep_embedding(t, m["time_embed_dim"]))
    frustum = ref.view_attn(x, p.cams, t_embed, t, sqrt_acp, sqrt_1macp, p.in_lat, p.in_cams, jitter)
    ctx = ref.cc_projection(p.clip_v)
    D, C = frustum.shape[3], frustum.shape[4]
    fr = frustum.permute(0, 3, 4, 1, 2).reshape(B, D * C, H, W)
    levels = {}
    for i in range(len(m["unet_channel_mult"])):
        lv = F.avg_pool2d(fr, 2**i) if i else fr
        levels[W >> i] = lv.reshape(B, D, C, H >> i, W >> i).permute(0, 3, 4, 1, 2)
    in_t = p.in_lat.expand(B, -1, -1, -1)
    x_cat = torch.cat([in_t[:, :4] / m["z_scale_factor"], in_t[:, 4:]], 1)  # the zero123 scale quirk
    # both passes in one batch: [conditional | null]
    x2 = torch.cat([torch.cat([x, x_cat], 1), torch.cat([x, torch.zeros_like(x_cat)], 1)])
    both = ref.unet(x2, torch.cat([t, t]), torch.cat([ctx, torch.zeros_like(ctx)]),
                    {k: torch.cat([v, torch.zeros_like(v)]) for k, v in levels.items()})
    s, s_uc = both[:B], both[B:]
    return s_uc + scale * (s - s_uc)


def ddim_sample(ref: ViewFusion, p: Prepared, init, step_noise, jitter, scale, num_steps, eta):
    """eta-DDIM on uniform timesteps with the SD +1 offset; loop step k runs
    index S-1-k and takes step_noise[k], jitter[k]; no noise at index 0.
    init (B, h, w, 5), step_noise (S, B, h, w, 5), jitter (S, B, h, w, D),
    NHWC; returns the final latents NHWC."""
    m = ref.m
    tables = ddpm_tables(m, init.device)
    abar = tables[0]
    ts = np.arange(0, m["timesteps"], m["timesteps"] // num_steps) + 1
    a_t = abar[ts]
    a_prev = np.concatenate([abar[0:1], a_t[:-1]])
    sig = eta * np.sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev))
    nchw = lambda a: a.permute(0, 3, 1, 2)
    x = nchw(init)
    B = x.shape[0]
    for k in range(num_steps):
        i = num_steps - 1 - k
        t = torch.full((B,), int(ts[i]), dtype=torch.long, device=x.device)
        eps = apply_model_cfg(ref, p, x, t, nchw(jitter[k]), scale, tables)
        x0 = (x - float(np.sqrt(1 - a_t[i])) * eps) / float(np.sqrt(a_t[i]))
        x = float(np.sqrt(a_prev[i])) * x0 + float(np.sqrt(max(1 - a_prev[i] - sig[i] ** 2, 1e-7))) * eps
        if i != 0:
            x = x + float(sig[i]) * nchw(step_noise[k])
    return x.permute(0, 2, 3, 1)
