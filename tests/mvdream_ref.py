"""A plain float32 replica of MVDream's inference path — test support only.

Written from MVDream's published code (github.com/bytedance/MVDream:
mvdream/ldm/modules/diffusionmodules/openaimodel.py's MultiViewUNetModel,
mvdream/ldm/modules/attention.py's SpatialTransformer3D and
BasicTransformerBlock3D, mvdream/ldm/modules/encoders/modules.py's
FrozenOpenCLIPEmbedder on open_clip's text transformer, mvdream/camera_utils.py,
the LDM DDIM sampler and scripts/t2i.py) and
mvdream/configs/sd-v2-base.yaml's sizes, with the published checkpoint's
state-dict names (model.diffusion_model.*, cond_stage_model.model.*,
first_stage_model.decoder.*, first_stage_model.post_quant_conv.*). Modules
are NCHW; every product is an nn.Linear, an nn.Conv2d or a plain matmul,
every attention an explicit softmax; rearranges are reshapes. It imports
nothing of mvdfusion_tpu_torch and no JAX; the SD VAE decoder is
tests/torch_ref.py's.

Departures from the published code:
- no tokenizer: token ids come in (the OpenCLIP BPE vocabulary is not in
  the repository);
- attention is computed explicitly where MVDream calls xformers'
  memory-efficient kernel: the same mathematics;
- dropout, checkpointing and the zero-initialised layers are left out:
  weights come from a seed, and dropout is 0 at inference;
- the DDIM loop runs eta 0 only (t2i.py's setting).

Products run in true float32: the towers' forwards and decode run with
TF32 off in cuBLAS and cuDNN (`float32_products`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from torch_ref import VAEDecoder


@contextlib.contextmanager
def float32_products():
    """torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32
    = False inside the block, the settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def attention(q, k, v, mask=None):
    """q (B, h, N, d), k / v (B, h, M, d) -> (B, h, N, d); `mask` (N, M)
    True where a key is hidden from a query."""
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if mask is not None:
        s = s.masked_fill(mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


# ----------------------------------------------------------------- the UNet
class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, dim_head):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x, context=None):
        context = x if context is None else context
        B, N, _ = x.shape
        M = context.shape[1]
        split = lambda t, n: t.reshape(B, n, self.heads, -1).transpose(1, 2)
        o = attention(split(self.to_q(x), N), split(self.to_k(context), M), split(self.to_v(context), M))
        return self.to_out(o.transpose(1, 2).reshape(B, N, -1))


class BasicTransformerBlock3D(nn.Module):
    """attn1 over the num_frames views of a group joined, attn2 and the FF
    per view."""

    def __init__(self, dim, heads, dim_head, context_dim, num_frames):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.num_frames = num_frames

    def forward(self, x, context):
        bf, l, c = x.shape
        f = self.num_frames
        x = x.reshape(bf // f, f * l, c)  # (b f) l c -> b (f l) c
        x = self.attn1(self.norm1(x)) + x
        x = x.reshape(bf, l, c)  # b (f l) c -> (b f) l c
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer3D(nn.Module):
    """GroupNorm, Linear proj_in over tokens, the block, Linear proj_out, + x."""

    def __init__(self, ch, heads, dim_head, depth, context_dim, num_frames):
        super().__init__()
        inner = heads * dim_head
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock3D(inner, heads, dim_head, context_dim, num_frames) for _ in range(depth)])
        self.proj_out = nn.Linear(inner, ch)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).reshape(b, c, h * w).transpose(1, 2))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return self.proj_out(y).transpose(1, 2).reshape(b, c, h, w) + x


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
    """openaimodel.py's TimestepEmbedSequential."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialTransformer3D):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


def timestep_embedding(t, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class MultiViewUNetModel(nn.Module):
    def __init__(self, m: dict):
        super().__init__()
        mc, frames = m["model_channels"], m["num_frames"]
        ted = mc * 4
        self.model_channels = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, ted), nn.SiLU(), nn.Linear(ted, ted))
        self.camera_embed = nn.Sequential(nn.Linear(m["camera_dim"], ted), nn.SiLU(), nn.Linear(ted, ted))
        hc = m["num_head_channels"]
        site = lambda ch: SpatialTransformer3D(ch, ch // hc, hc, m["transformer_depth"], m["context_dim"], frames)
        attn = tuple(m["attention_resolutions"])
        self.input_blocks = nn.ModuleList([Seq(nn.Conv2d(m["in_channels"], mc, 3, padding=1))])
        ch, ds, chans = mc, 1, [mc]
        mults = tuple(m["channel_mult"])
        for level, mult in enumerate(mults):
            for _ in range(m["num_res_blocks"]):
                layers = [ResBlock(ch, ted, mult * mc)]
                ch = mult * mc
                if ds in attn:
                    layers.append(site(ch))
                self.input_blocks.append(Seq(*layers))
                chans.append(ch)
            if level != len(mults) - 1:
                self.input_blocks.append(Seq(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = Seq(ResBlock(ch, ted, ch), site(ch), ResBlock(ch, ted, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(mults))):
            for i in range(m["num_res_blocks"] + 1):
                layers = [ResBlock(ch + chans.pop(), ted, mult * mc)]
                ch = mult * mc
                if ds in attn:
                    layers.append(site(ch))
                if level and i == m["num_res_blocks"]:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Seq(*layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(), nn.Conv2d(mc, m["out_channels"], 3, padding=1))

    @float32_products()
    def forward(self, x, t, context, camera):
        """x (B, C, h, w), t (B,), context (B, M, ctx), camera (B, 16); B a
        multiple of num_frames, each group of num_frames rows one object."""
        emb = self.time_embed(timestep_embedding(t, self.model_channels)) + self.camera_embed(camera)
        hs, h = [], x
        for blk in self.input_blocks:
            h = blk(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for blk in self.output_blocks:
            h = blk(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h)


# ---------------------------------------------------------- the text tower
class TextAttention(nn.Module):
    """nn.MultiheadAttention's parameter names, computed explicitly."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask):
        B, N, C = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias).reshape(B, N, 3, self.heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        return self.out_proj(attention(q, k, v, mask).transpose(1, 2).reshape(B, N, C))


class TextResblock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = TextAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.ModuleDict({"c_fc": nn.Linear(width, 4 * width), "c_proj": nn.Linear(4 * width, width)})

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp["c_proj"](F.gelu(self.mlp["c_fc"](self.ln_2(x))))


class TextTransformer(nn.Module):
    """open_clip's text tower as FrozenOpenCLIPEmbedder runs it at layer
    "penultimate": every resblock but the last, then ln_final."""

    def __init__(self, m: dict):
        super().__init__()
        w = m["text_width"]
        self.token_embedding = nn.Embedding(m["text_vocab_size"], w)
        self.positional_embedding = nn.Parameter(torch.empty(m["text_context_length"], w))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList([TextResblock(w, m["text_heads"]) for _ in range(m["text_layers"])])
        self.ln_final = nn.LayerNorm(w)

    @float32_products()
    def forward(self, tokens):
        n = tokens.shape[1]
        mask = torch.ones(n, n, dtype=torch.bool, device=tokens.device).triu(1)
        x = self.token_embedding(tokens) + self.positional_embedding
        for blk in self.transformer.resblocks[:-1]:
            x = blk(x, mask)
        return self.ln_final(x)


# --------------------------------------------------------------- the model
class _Holder(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class MVDream(nn.Module):
    """`m`: nn/mvdream.py's configuration as a dict (MVDreamConfig's fields)."""

    def __init__(self, m: dict):
        super().__init__()
        self.m = m
        self.model = _Holder(diffusion_model=MultiViewUNetModel(m))
        self.cond_stage_model = _Holder(model=TextTransformer(m))
        self.first_stage_model = _Holder(
            decoder=VAEDecoder(m["vae_ch"], tuple(m["vae_ch_mult"]), m["vae_num_res_blocks"], m["vae_z_channels"]),
            post_quant_conv=nn.Conv2d(m["vae_embed_dim"], m["vae_z_channels"], 1))

    @property
    def unet(self):
        return self.model.diffusion_model


# ------------------------------------------------------------ the pipeline
def get_camera(num_frames, elevation=15.0, azimuth_start=0.0, azimuth_span=360.0):
    """camera_utils.py::get_camera: (num_frames, 16), each view's
    camera-to-world (OpenGL look-at the origin from the unit sphere, +y up)
    left-multiplied by the OpenGL -> Blender flip, flattened."""
    flip = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float64)
    out = []
    for azim in np.arange(azimuth_start, azimuth_span + azimuth_start, azimuth_span / num_frames)[:num_frames]:
        e, a = np.radians(elevation), np.radians(azim)
        pos = np.array([np.cos(e) * np.sin(a), np.sin(e), np.cos(e) * np.cos(a)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        up = up / np.linalg.norm(up)
        c2w = np.eye(4)
        c2w[:3, :3] = np.array([right, up, -fwd]).T
        c2w[:3, 3] = pos
        out.append((flip @ c2w).flatten())
    return torch.tensor(np.stack(out), dtype=torch.float32)


def encode_text(ref: MVDream, tokens):
    return ref.cond_stage_model.model(tokens)


def apply_model_cfg(ref: MVDream, x, t, context, uncond, camera, scale):
    """x (F, C, h, w) of one object, context / uncond (1, M, ctx), camera
    (F, 16): the [uncond | cond] batch of t2i.py's sampler, mixed."""
    f = x.shape[0]
    both = ref.unet(torch.cat([x, x]), torch.full((2 * f,), int(t), dtype=torch.long, device=x.device),
                    torch.cat([uncond.expand(f, -1, -1), context.expand(f, -1, -1)]), torch.cat([camera, camera]))
    e_u, e_c = both[:f], both[f:]
    return e_u + scale * (e_c - e_u)


def ddim_sample(ref: MVDream, context, uncond, camera, init, scale, num_steps):
    """The LDM DDIM sampler at eta 0 on uniform timesteps (1, 1 + T/S, ...)
    for one object: init (F, h, w, C) NHWC; returns the latents NHWC."""
    m = ref.m
    betas = np.linspace(m["linear_start"] ** 0.5, m["linear_end"] ** 0.5, m["timesteps"], dtype=np.float64) ** 2
    abar = np.cumprod(1.0 - betas)
    ts = np.arange(0, m["timesteps"], m["timesteps"] // num_steps) + 1
    a_t = abar[ts]
    a_prev = np.concatenate([abar[:1], a_t[:-1]])
    x = init.permute(0, 3, 1, 2)
    for k in range(num_steps):
        i = num_steps - 1 - k
        e = apply_model_cfg(ref, x, ts[i], context, uncond, camera, scale)
        x0 = (x - float(np.sqrt(1.0 - a_t[i])) * e) / float(np.sqrt(a_t[i]))
        x = float(np.sqrt(a_prev[i])) * x0 + float(np.sqrt(1.0 - a_prev[i])) * e
    return x.permute(0, 2, 3, 1)


@float32_products()
def decode(ref: MVDream, z):
    """Latents NHWC (B, h, w, 4) -> [0, 1] images NHWC."""
    fs = ref.first_stage_model
    x = fs.decoder(fs.post_quant_conv(z.permute(0, 3, 1, 2) / ref.m["scale_factor"]))
    return torch.clamp((x + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)
