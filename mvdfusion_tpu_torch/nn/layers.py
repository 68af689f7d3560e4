"""Shared building blocks for the SD1-family towers (torch counterpart of
mvdfusion_tpu/nn/layers.py).

Conventions: activations are NHWC / (B, N, C) as in the JAX package; linear
and conv layers compute in their weight's dtype (bf16 towers, fp32 norms and
small MLPs); GroupNorm, LayerNorm and softmax run in fp32 islands and cast
back. Parameter names follow the reference checkpoint's torch modules.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdfusion_tpu_torch.ops.attention import attention_plain, fused_attention, should_fuse_attention
from mvdfusion_tpu_torch.ops.groupnorm import group_norm_act, group_norm_plain, should_fuse_gn


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """SD sinusoidal embedding, [cos | sin] order; (B,) -> (B, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Linear(nn.Linear):
    """nn.Linear over the last dim, computing in the weight's dtype."""

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv1x1(nn.Module):
    """A torch 1x1 Conv2d's parameters ((out, in, 1, 1) weight), applied to
    channels-last input as a per-token linear map. Below fp32 it rounds where
    the reference's flax Dense(dtype) rounds: the product, then the bias add
    in the weight's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        w = self.weight[:, :, 0, 0]
        if w.dtype == torch.float32:
            return F.linear(x.float(), w, self.bias)
        return F.linear(x.to(w.dtype), w) + self.bias.to(w.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC input (a channels-last view, no copy), computing in
    the weight's dtype."""

    def forward(self, x):
        y = super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32 over NHWC input, optional fused SiLU. Gated
    maps go through ops/groupnorm.py's wrapper: K1 for slices of at most 2^20
    elements, the tiled K7 for larger maps under MVDF_GN_TILED=1 (the VAE's
    64^2..256^2 maps; the decoder's 256^2 norm_out also with the fused convs
    on)."""

    def __init__(self, channels: int, eps: float = 1e-5, act: str = "none"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.act = eps, act

    def forward(self, x):
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])
        if should_fuse_gn(x.shape, 32):
            y = group_norm_act(x3, self.weight, self.bias, 32, self.eps, self.act)
        else:
            y = group_norm_plain(x3, self.weight, self.bias, 32, self.eps, self.act)
        return y.reshape(x.shape)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32, cast back to the input dtype."""

    def forward(self, x):
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


def dot_attention(q, k, v, scale: float):
    """(B, Nq, H, dh) multi-head attention with fp32 softmax; the large-token
    sites go through the K2 kernel wrapper (ops/attention.py)."""
    if should_fuse_attention(q, k):
        return fused_attention(q, k, v, scale)
    return attention_plain(q, k, v, scale)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        y, gate = self.proj(x).chunk(2, dim=-1)
        return y * F.gelu(gate.float()).to(y.dtype)


class FeedForward(nn.Module):
    """LDM FeedForward with a GEGLU gate; keys net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class CrossAttention(nn.Module):
    """LDM CrossAttention: bias-free q/k/v, biased to_out.0; self-attention
    when context is None. A 1-token context is exactly to_out(to_v(ctx))
    (softmax over one key is 1), broadcast over the queries."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None):
        if context is not None and context.shape[1] == 1:
            out = self.to_out[0](self.to_v(context))
            return out.expand(*x.shape[:2], out.shape[-1])
        context = x if context is None else context
        B, Nq, _ = x.shape
        Nk = context.shape[1]
        q = self.to_q(x).reshape(B, Nq, self.heads, self.dim_head)
        k = self.to_k(context).reshape(B, Nk, self.heads, self.dim_head)
        v = self.to_v(context).reshape(B, Nk, self.heads, self.dim_head)
        out = dot_attention(q, k, v, self.dim_head**-0.5).reshape(B, Nq, -1)
        return self.to_out[0](out)


class TimmAttention(nn.Module):
    """timm ViT attention: fused biased qkv, biased proj."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = (a.reshape(B, N, self.heads, C // self.heads) for a in self.qkv(x).chunk(3, dim=-1))
        return self.proj(dot_attention(q, k, v, (C // self.heads) ** -0.5).reshape(B, N, C))


class Mlp(nn.Module):
    """timm Mlp: fc1 -> exact GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def silu(x):
    return x * torch.sigmoid(x)
