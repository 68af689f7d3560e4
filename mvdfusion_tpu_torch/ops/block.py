"""K3: the UNet transformer site (SpatialTransformer / ViewAligned interior).

Replaces the split form of mvdfusion_tpu/ops/block.py::_fwd_impl:
_attn_kernel (site GroupNorm eps 1e-6, proj_in, LN1, multi-head
self-attention with fp32 softmax, out-proj, residual, + the precomputed attn2
term) and _ff_kernel (LN3, GEGLU with exact erf, FF out, residual, proj_out,
+ x_in). On the card the site is a short sequence of hand-written kernels:
K1 for the site GroupNorm, csrc/block.cu's LayerNorm and its tensor-core GEMM
with a fused epilogue for every product (bias, residuals, the attn2 add,
GEGLU), and K2 for the self-attention on the packed qkv. No product goes to
torch.matmul or cuBLAS.

The GEMM and LayerNorm launchers here also serve K4 (ops/crossview.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.attention import attention_plain, launch_attention
from mvdfusion_tpu_torch.ops.groupnorm import group_norm_plain, launch_group_norm

_LN_EPS = 1e-5
_GN_GROUPS = 32
_GN_EPS = 1e-6
_BIG_C_MIN = 768
ACT_NONE, ACT_GELU, ACT_GEGLU = 0, 1, 2
_GEGLU_HALF = 32  # half the GEMM's 64-column tile


class BlockWeights(NamedTuple):
    """A site's weights in nn.Linear (out_features, in_features) layout."""

    gn_w: torch.Tensor  # (C,) site GroupNorm
    gn_b: torch.Tensor
    pi_w: torch.Tensor  # (C, C) proj_in
    pi_b: torch.Tensor
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_w: torch.Tensor  # (3C, C) rows [Wq; Wk; Wv], no bias
    out_w: torch.Tensor  # (C, C) attn1 to_out
    out_b: torch.Tensor
    ln3_w: torch.Tensor
    ln3_b: torch.Tensor
    g_w: torch.Tensor  # (2*inner, C) GEGLU proj, rows [value; gate]
    g_b: torch.Tensor
    f_w: torch.Tensor  # (C, inner) FF out
    f_b: torch.Tensor
    po_w: torch.Tensor  # (C, C) proj_out
    po_b: torch.Tensor


def should_fuse_block(C: int, N: int, heads: int) -> bool:
    """The reference's gate (ops/block.py::should_fuse_block, big-C form
    off): the 32^2 C=320 and 16^2 C=640 sites of the flagship."""
    if C % heads or (C // heads) % 8 or C % _GN_GROUPS or C > _BIG_C_MIN or N % 128:
        return False
    return (C <= 384 and N <= 1024) or (C <= 768 and N <= 256)


# ------------------------------------------------------------ kernel launchers
def _f32(t):
    return None if t is None else t.float().contiguous()


def layernorm(x, weight=None, bias=None, eps: float = _LN_EPS, out_dtype=None):
    """csrc/block.cu LayerNorm over the last dim of a CUDA (M, C) tensor;
    fp32 statistics; input fp32 or bf16, output `out_dtype`."""
    C = x.shape[-1]
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype or x.dtype, device=x.device)
    _lib.call(
        "mvdf_layernorm", x, _lib.is_bf16(x), _f32(weight), _f32(bias),
        y, _lib.is_bf16(y), x.numel() // C, C, float(eps),
    )
    return y


def pack_geglu(w, b):
    """Reorder GEGLU rows [value; gate] so each 64-row GEMM tile holds 32
    value rows followed by their 32 gate rows."""
    inner = w.shape[0] // 2
    if inner % _GEGLU_HALF:
        raise ValueError(f"GEGLU inner dim {inner} is not a multiple of {_GEGLU_HALF}")
    t = inner // _GEGLU_HALF
    wp = w.reshape(2, t, _GEGLU_HALF, w.shape[1]).transpose(0, 1).reshape(2 * inner, w.shape[1])
    bp = b.reshape(2, t, _GEGLU_HALF).transpose(0, 1).reshape(2 * inner)
    return wp.contiguous(), bp


def gemm(a, w, bias=None, *, out_dtype=None, res1=None, res2=None, res2_div: int = 1, gate=None,
         act: int = ACT_NONE, out=None):
    """csrc/block.cu GEMM: epilogue(a (M, K) @ w (N, K)^T) on CUDA tensors.

    epilogue: + bias, then GELU (act=1) or GEGLU over packed rows (act=2, see
    pack_geglu; output has N/2 columns), then * gate[col], + res1[row],
    + res2[row // res2_div], computed in fp32 and rounded once. `out` may
    alias `res1` (an in-place residual update)."""
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K or w.dtype != a.dtype:
        raise ValueError(f"gemm operands {tuple(a.shape)} {a.dtype} x {tuple(w.shape)} {w.dtype}")
    a = a.contiguous()
    w = w.contiguous()
    if a.dtype == torch.bfloat16 and (K % 8 or a.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 GEMM needs K % 8 == 0 and 16-byte aligned operands")
    if act == ACT_GEGLU and N % 64:
        raise ValueError("GEGLU needs N % 64 == 0")
    n_out = N // 2 if act == ACT_GEGLU else N
    if out is None:
        out = torch.empty(M, n_out, dtype=out_dtype or a.dtype, device=a.device)
    for r, rows in ((res1, M), (res2, M // max(res2_div, 1))):
        if r is not None and (r.shape[-1] != n_out or r.numel() != rows * n_out):
            raise ValueError(f"residual {tuple(r.shape)} does not match ({rows}, {n_out})")
    _lib.call(
        "mvdf_gemm", a, w, _f32(bias), out, _lib.is_bf16(out),
        res1, _lib.is_bf16(res1), res2, _lib.is_bf16(res2), int(res2_div),
        _f32(gate), int(act), M, N, K, _lib.dtype_code(a.dtype),
    )
    return out


# ------------------------------------------------------------------ the site
def _ln_plain(h, w, b, eps=_LN_EPS):
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = torch.clamp((hf * hf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return ((hf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(h.dtype)


def transformer_block_plain(x_in, attn2_add, w: BlockWeights, heads: int):
    """Plain PyTorch version: x_in (B, N, C) pre-GN site input, attn2_add a
    (B, C) row or (B, N, C) map -> x_in + proj_out(block(proj_in(GN(x_in))))."""
    dt = x_in.dtype
    B, N, C = x_in.shape
    dh = C // heads

    def dense(h, k, b=None):
        return F.linear(h, k.to(h.dtype), None if b is None else b.to(h.dtype))

    x_gn = group_norm_plain(x_in, w.gn_w, w.gn_b, _GN_GROUPS, _GN_EPS)
    h0 = dense(x_gn, w.pi_w, w.pi_b)
    qkv = dense(_ln_plain(h0, w.ln1_w, w.ln1_b), w.qkv_w).reshape(B, N, 3, heads, dh)
    attn = attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh**-0.5).reshape(B, N, C)
    h1 = h0 + dense(attn, w.out_w, w.out_b)
    a2 = attn2_add if attn2_add.ndim == 3 else attn2_add[:, None, :]
    h2 = h1 + a2.to(dt)
    g = dense(_ln_plain(h2, w.ln3_w, w.ln3_b), w.g_w, w.g_b)
    inner = w.f_w.shape[1]
    y = g[..., :inner] * F.gelu(g[..., inner:].float()).to(dt)
    h3 = h2 + dense(y, w.f_w, w.f_b)
    return x_in + dense(h3, w.po_w, w.po_b)


def launch_transformer_block(x_in, attn2_add, w: BlockWeights, heads: int):
    """The site on the card: K1, LayerNorm, GEMMs and K2 (no counting)."""
    B, N, C = x_in.shape
    dt = x_in.dtype
    M, dh = B * N, C // heads
    cast = lambda t: t.to(dt).contiguous()
    x = x_in.contiguous()
    xg = launch_group_norm(x, w.gn_w, w.gn_b, _GN_GROUPS, _GN_EPS).view(M, C)
    h0 = gemm(xg, cast(w.pi_w), w.pi_b)
    qkv = gemm(layernorm(h0, w.ln1_w, w.ln1_b), cast(w.qkv_w)).view(B, N, 3, heads, dh)
    attn = launch_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh**-0.5).view(M, C)
    a2 = attn2_add.to(dt).contiguous()
    h2 = gemm(attn, cast(w.out_w), w.out_b, res1=h0, res2=a2, res2_div=1 if a2.ndim == 3 else N)
    g_w, g_b = pack_geglu(cast(w.g_w), w.g_b)
    y = gemm(layernorm(h2, w.ln3_w, w.ln3_b), g_w, g_b, act=ACT_GEGLU)
    h3 = gemm(y, cast(w.f_w), w.f_b, res1=h2)
    return gemm(h3, cast(w.po_w), w.po_b, res1=x.view(M, C)).view(B, N, C)


def transformer_block(x_in, attn2_add, w: BlockWeights, heads: int):
    """One transformer site: the CUDA kernel sequence for CUDA tensors, the
    plain version for CPU tensors."""
    if not x_in.is_cuda:
        return transformer_block_plain(x_in, attn2_add, w, heads)
    out = launch_transformer_block(x_in, attn2_add, w, heads)
    _lib.LAUNCHES["transformer_block"] += 1
    return out
