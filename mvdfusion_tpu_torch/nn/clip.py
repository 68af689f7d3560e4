"""OpenAI CLIP ViT-L/14 image tower (torch counterpart of mvdfusion_tpu/nn/clip.py).

Preprocessing reproduces the reference's quirk chain: bicubic align_corners
resize to 224, then (x + 1) / 2 on [0, 1] input, then CLIP mean/std. The
tower is pre-LN with QuickGELU MLPs, ln_post on the CLS token and a linear
projection. Names follow clip's VisionTransformer (conv1, class_embedding,
positional_embedding, ln_pre, transformer.resblocks.{i}.attn.in_proj_weight,
ln_post, proj). Attention at 257 tokens goes through the K2 kernel wrapper.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdfusion_tpu_torch.nn.layers import Conv2d, LayerNormFp32, Linear, dense, dot_attention
from mvdfusion_tpu_torch.ops.image import bicubic_resize

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> normalised (B, 224, 224, 3) fp32."""
    x = bicubic_resize(images, 224, 224)
    x = (x + 1.0) / 2.0
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


class CLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameters: packed in_proj, out_proj."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        B, N, C = x.shape
        dh = C // self.heads
        qkv = dense(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (a.reshape(B, N, self.heads, dh) for a in qkv.chunk(3, dim=-1))
        return self.out_proj(dot_attention(q, k, v, dh**-0.5).reshape(B, N, C))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = CLIPAttention(width, heads)
        self.ln_1 = LayerNormFp32(width)
        self.mlp = _MLP(width)
        self.ln_2 = LayerNormFp32(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads) for _ in range(layers)])


class VisionTransformer(nn.Module):
    """Returns the projected CLS embedding (B, output_dim) fp32."""

    def __init__(self, width=1024, layers=24, heads=16, patch_size=14, image_size=224, output_dim=768):
        super().__init__()
        n_tokens = (image_size // patch_size) ** 2 + 1
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(width) * width**-0.5)
        self.positional_embedding = nn.Parameter(torch.randn(n_tokens, width) * 0.01)
        self.ln_pre = LayerNormFp32(width)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = LayerNormFp32(width)
        self.proj = nn.Parameter(torch.randn(width, output_dim) / math.sqrt(width))

    def forward(self, x):
        h = self.conv1(x)  # (B, 16, 16, width)
        B, W = h.shape[0], h.shape[-1]
        h = h.reshape(B, -1, W)
        cls = self.class_embedding.to(h.dtype).expand(B, 1, W)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.ln_pre(h)
        for blk in self.transformer.resblocks:
            h = blk(h)
        cls_out = self.ln_post(h[:, 0])
        return (cls_out @ self.proj.to(cls_out.dtype)).float()


class _CLIPModel(nn.Module):
    def __init__(self, **kw):
        super().__init__()
        self.visual = VisionTransformer(**kw)


class FrozenCLIPImageEmbedder(nn.Module):
    """[0, 1] NHWC images -> (B, 1, output_dim)."""

    def __init__(self, width=1024, layers=24, heads=16, output_dim=768):
        super().__init__()
        self.model = _CLIPModel(width=width, layers=layers, heads=heads, output_dim=output_dim)

    def forward(self, images):
        return self.model.visual(clip_preprocess(images))[:, None, :]
