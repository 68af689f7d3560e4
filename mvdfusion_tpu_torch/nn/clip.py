"""OpenAI CLIP ViT-L/14 image tower (torch counterpart of mvdfusion_tpu/nn/clip.py),
and OpenCLIP ViT-H/14's text tower as MVDream conditions on it.

Preprocessing reproduces the reference's quirk chain: bicubic align_corners
resize to 224, then (x + 1) / 2 on [0, 1] input, then CLIP mean/std. The
tower is pre-LN with QuickGELU MLPs, ln_post on the CLS token and a linear
projection. Names follow clip's VisionTransformer (conv1, class_embedding,
positional_embedding, ln_pre, transformer.resblocks.{i}.attn.in_proj_weight,
ln_post, proj). Attention at 257 tokens goes through the K2 kernel wrapper.

Under tensor parallelism (parallel/mesh.py) the packed in_proj and c_fc are
column layers, out_proj, c_proj and proj row layers, and the patch conv is
split by its output features: a rank runs K2 on its own heads, its slice of
the packed weight holding the same heads of q, of k and of v.

The text tower (FrozenOpenCLIPEmbedder, layer "penultimate", as in
ldm/modules/encoders/modules.py): token and positional embeddings, the
same resblocks with a causal mask and exact-GELU MLPs, all but the last
run, then ln_final; (B, 77) token ids -> (B, 77, width). Its causal
attention takes the plain path (K2 is unmasked). Names follow open_clip's
text model (token_embedding, positional_embedding,
transformer.resblocks.{i}, ln_final).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdfusion_tpu_torch.nn.layers import Conv2d, LayerNormFp32, Linear, column_dense, consumed, dense, dot_attention
from mvdfusion_tpu_torch.ops.image import bicubic_resize
from mvdfusion_tpu_torch.parallel.tensor import gather_from, reduce_from, scatter_to, split_of

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

    def forward(self, x, causal: bool = False):
        B, N, C = x.shape
        dh, heads = C // self.heads, self.heads
        s = split_of(self.in_proj_weight)
        if s is None:
            qkv = dense(x, self.in_proj_weight, self.in_proj_bias)
        else:
            qkv = column_dense(x, self.in_proj_weight, self.in_proj_bias, s)  # this rank's q | k | v slices
            if heads % s.axis.size or split_of(self.out_proj.weight) is None:
                qkv = gather_from(qkv, s.axis, -1, 3)
            else:
                heads //= s.axis.size
        q, k, v = (a.reshape(B, N, heads, dh) for a in qkv.chunk(3, dim=-1))
        return self.out_proj(dot_attention(q, k, v, dh**-0.5, causal=causal).reshape(B, N, heads * dh))


class _MLP(nn.Module):
    """c_fc -> QuickGELU (OpenAI CLIP) or the exact GELU (`gelu`, open_clip's
    nn.GELU) -> c_proj."""

    def __init__(self, width: int, gelu: bool = False):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)
        self.gelu = gelu

    def forward(self, x):
        h = consumed(self.c_fc, self.c_proj, x)
        return self.c_proj(F.gelu(h) if self.gelu else h * torch.sigmoid(1.702 * h))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block; `causal` masks each token's attention to itself and
    the tokens before it; `gelu` as in _MLP."""

    def __init__(self, width: int, heads: int, causal: bool = False, gelu: bool = False):
        super().__init__()
        self.attn = CLIPAttention(width, heads)
        self.ln_1 = LayerNormFp32(width)
        self.mlp = _MLP(width, gelu)
        self.ln_2 = LayerNormFp32(width)
        self.causal = causal

    def forward(self, x):
        x = x + self.attn(self.ln_1(x), self.causal)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool = False, gelu: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads, causal, gelu) for _ in range(layers)])


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
        s = split_of(self.proj)
        if s is None:
            return (cls_out @ self.proj.to(cls_out.dtype)).float()
        # a row layer on (in, out): this rank's input rows, fp32 partials summed, then rounded once
        part = scatter_to(cls_out, s.axis, -1).float() @ self.proj.to(cls_out.dtype).float()
        return reduce_from(part, s.axis).to(cls_out.dtype).float()


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


class _OpenCLIPText(nn.Module):
    def __init__(self, vocab_size: int, context_length: int, width: int, layers: int, heads: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.randn(context_length, width) * 0.01)
        self.transformer = _Transformer(width, layers, heads, causal=True, gelu=True)
        self.ln_final = LayerNormFp32(width)


class FrozenOpenCLIPEmbedder(nn.Module):
    """(B, context_length) token ids -> (B, context_length, width) at layer
    "penultimate": the embeddings, every resblock but the last, ln_final."""

    def __init__(self, vocab_size=49408, context_length=77, width=1024, layers=24, heads=16):
        super().__init__()
        self.model = _OpenCLIPText(vocab_size, context_length, width, layers, heads)

    def forward(self, tokens):
        m = self.model
        h = m.token_embedding(tokens) + m.positional_embedding.to(m.token_embedding.weight.dtype)
        for blk in m.transformer.resblocks[:-1]:
            h = blk(h)
        return m.ln_final(h)
