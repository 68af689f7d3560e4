"""Shared building blocks for the SD1-family towers (torch counterpart of
mvdfusion_tpu/nn/layers.py).

Conventions: activations are NHWC / (B, N, C) as in the JAX package; linear
and conv layers compute in their weight's dtype (bf16 towers, fp32 norms and
small MLPs); GroupNorm, LayerNorm and softmax run in fp32 islands and cast
back. Parameter names follow the reference checkpoint's torch modules.

Under tensor parallelism (parallel/mesh.py::shard_params_) a layer whose
weight carries a Split runs on its shard (parallel/tensor.py): a column
layer (outputs split) on `copy_to` of its input, its output gathered unless
`local` is asked for by a row layer that consumes it; a row layer (inputs
split) on its input's own slice (a whole input it cuts itself), its fp32
partial products summed over the ranks, then rounded once and the bias
added once, as `dense` rounds; a split conv on its output features, gathered
after it. Biases stay whole and are sliced at use.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mvdfusion_tpu_torch.ops.attention import fused_attention, should_fuse_attention, xla_attention
from mvdfusion_tpu_torch.ops.groupnorm import group_norm_act, gn_route
from mvdfusion_tpu_torch.parallel.tensor import copy_to, gather_from, local_bias, reduce_from, scatter_to, split_of


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


def dense(x, weight, bias=None):
    """x @ weight^T + bias in the weight's dtype. Below fp32 it rounds where
    the reference's flax Dense(dtype) rounds: the product, then the bias add
    in the weight's dtype."""
    x = x.to(weight.dtype)
    if bias is None or weight.dtype == torch.float32:
        return F.linear(x, weight, bias)
    return F.linear(x, weight) + bias.to(weight.dtype)


def _mm_f32(a, b):
    """a @ b in fp32 from two matrices of one low-precision dtype: on the
    card one tensor-core GEMM with an fp32 output, on the CPU in fp32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _PartialProduct(torch.autograd.Function):
    """x @ w^T in fp32 from x and w of w's low-precision dtype: a row
    layer's partial product. Its one consumer rounds it to w's dtype (after
    the sum over ranks), so the cotangent that comes back holds values of
    w's dtype and the backward's products take it in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1]).to(w.dtype)
        gx = _mm_f32(g, w).to(x.dtype).reshape(x.shape) if ctx.needs_input_grad[0] else None
        gw = _mm_f32(g.t(), x.reshape(-1, x.shape[-1])).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def row_dense(x, weight, bias, split):
    """A row layer: x (whole, or this rank's slice of the inputs) against
    this rank's input columns of `weight`; the fp32 partial products summed
    over the ranks, then rounded to the weight's dtype once and the bias
    added once, where `dense` rounds."""
    axis = split.axis
    if x.shape[-1] == weight.shape[1] * axis.size:
        x = scatter_to(x, axis, -1)
    x = x.to(weight.dtype)
    part = F.linear(x, weight) if weight.dtype == torch.float32 else _PartialProduct.apply(x, weight)
    y = reduce_from(part, axis).to(weight.dtype)
    return y if bias is None else y + bias.to(weight.dtype)


def column_dense(x, weight, bias, split):
    """A column layer's output slice: this rank's outputs (of each packed
    block) of x @ weight^T + bias."""
    return dense(copy_to(x, split.axis), weight, local_bias(bias, weight))


class Linear(nn.Linear):
    """nn.Linear over the last dim, computing in the weight's dtype and
    rounding as flax's Dense (`dense`); split: a column or a row layer."""

    def local(self, x):
        """The output, left as this rank's slice where the layer is a column
        layer (for a row layer that consumes it)."""
        s = split_of(self.weight)
        if s is None:
            return dense(x, self.weight, self.bias)
        if s.dim == 0:
            return column_dense(x, self.weight, self.bias, s)
        return row_dense(x, self.weight, self.bias, s)

    def forward(self, x):
        s = split_of(self.weight)
        y = self.local(x)
        return gather_from(y, s.axis, -1, s.parts) if s is not None and s.dim == 0 else y


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
        return dense(x, self.weight[:, :, 0, 0], self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d on NHWC input (a channels-last view, no copy), computing in
    the weight's dtype; split (output features), its outputs gathered."""

    def forward(self, x):
        x = x.to(self.weight.dtype)
        s = split_of(self.weight)
        if s is None:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self._conv_forward(copy_to(x, s.axis).permute(0, 3, 1, 2), self.weight, local_bias(self.bias, self.weight))
        return gather_from(y.permute(0, 2, 3, 1), s.axis, -1)


class GroupNorm32(nn.Module):
    """GroupNorm(32) in fp32 over NHWC input, optional fused SiLU, on
    ops/groupnorm.py::gn_route's route: K1 for slices of at most 2^20
    elements; on the card the tiled K7 for every larger map (the VAE's
    64^2..256^2 maps), on the CPU the reference's route (K7's plain version
    under MVDF_GN_TILED=1, else the plain GroupNorm)."""

    def __init__(self, channels: int, eps: float = 1e-5, act: str = "none"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.act = eps, act

    def forward(self, x):
        x3 = x.reshape(x.shape[0], -1, x.shape[-1])
        route = gn_route(x.shape, 32, x.device.type)
        return group_norm_act(x3, self.weight, self.bias, 32, self.eps, self.act, route).reshape(x.shape)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32, cast back to the input dtype."""

    def forward(self, x):
        w = None if self.weight is None else self.weight.float()
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


def dot_attention(q, k, v, scale: float, causal: bool = False):
    """(B, Nq, H, dh) multi-head attention with fp32 softmax; the large-token
    sites go through the K2 kernel wrapper (ops/attention.py). K2 is
    unmasked: a causal call takes the plain path."""
    if not causal and should_fuse_attention(q, k):
        return fused_attention(q, k, v, scale)
    return xla_attention(q, k, v, scale, causal)


class GEGLU(nn.Module):
    """value * gelu(gate) from one packed projection [value | gate]; split,
    each rank holds the same rows of both halves, so its slice of the
    product is its own."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def local(self, x):
        y, gate = self.proj.local(x).chunk(2, dim=-1)
        return y * F.gelu(gate.float()).to(y.dtype)

    def forward(self, x):
        s = split_of(self.proj.weight)
        y = self.local(x)
        return y if s is None else gather_from(y, s.axis, -1)


def consumed(producer, consumer: Linear, x):
    """producer's output as `consumer`'s input: left as this rank's slice
    where `consumer` is a row layer (which takes a slice or a whole input),
    else whole."""
    s = split_of(consumer.weight)
    return producer.local(x) if s is not None and s.dim == 1 else producer(x)


class FeedForward(nn.Module):
    """LDM FeedForward with a GEGLU gate; keys net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](consumed(self.net[0], self.net[2], x))


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

    def one_key(self, context):
        """to_out(to_v(context)): the output for a 1-key context."""
        return self.to_out[0](consumed(self.to_v, self.to_out[0], context))

    def _local_heads(self) -> int:
        """The heads this rank runs: all of them, or where to_out is a row
        layer over n ranks and n divides them, heads / n (q, k and v then
        cut to this rank's heads, to_out reading the slice)."""
        s = split_of(self.to_out[0].weight)
        return self.heads if s is None or self.heads % s.axis.size else self.heads // s.axis.size

    def _project(self, layer: Linear, x, heads: int):
        """layer(x) as this rank's `heads` heads."""
        s = split_of(layer.weight)
        if heads == self.heads:
            return layer(x)
        if s is not None:
            return layer.local(x)
        return scatter_to(layer(x), split_of(self.to_out[0].weight).axis, -1)

    def forward(self, x, context=None):
        if context is not None and context.shape[1] == 1:
            out = self.one_key(context)
            return out.expand(*x.shape[:2], out.shape[-1])
        context = x if context is None else context
        B, Nq, _ = x.shape
        Nk = context.shape[1]
        h = self._local_heads()
        q = self._project(self.to_q, x, h).reshape(B, Nq, h, self.dim_head)
        k = self._project(self.to_k, context, h).reshape(B, Nk, h, self.dim_head)
        v = self._project(self.to_v, context, h).reshape(B, Nk, h, self.dim_head)
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


def gelu_exact(y):
    """The exact GELU rounded where jax.nn.gelu(approximate=False) rounds, op
    by op in y's dtype: (0.5 y) * erfc(-y * sqrt(1/2)), sqrt(1/2) in that
    dtype."""
    return (0.5 * y) * torch.special.erfc(-y * torch.tensor(math.sqrt(0.5), dtype=y.dtype))


class Mlp(nn.Module):
    """timm Mlp: fc1 -> exact GELU (gelu_exact) -> fc2."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out)

    def forward(self, x):
        return self.fc2(gelu_exact(consumed(self.fc1, self.fc2, x)))


def silu(x):
    return x * torch.sigmoid(x)
