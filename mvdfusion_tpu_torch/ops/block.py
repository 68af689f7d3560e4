"""K3, K5 and K6: the UNet transformer site (SpatialTransformer / ViewAligned
interior) in the three forms of mvdfusion_tpu/ops/block.py::_fwd_impl.

The site: site GroupNorm (eps 1e-6), proj_in, LN1, multi-head self-attention
with an fp32 softmax, out-proj, residual, + the precomputed attn2 term, LN3,
GEGLU with exact erf, FF out, residual, proj_out, + x_in. `block_route`
picks the form where the reference does:
- split (K3, the default): _attn_kernel + _ff_kernel. On the card a short
  sequence of hand-written kernels: K1 for the site GroupNorm, csrc/block.cu's
  LayerNorm and its tensor-core GEMM with a fused epilogue for every product
  (bias, residuals, the attn2 add, GEGLU), and K2 for the self-attention on
  the packed qkv.
- one kernel (K5, under MVDF_BLOCK_SINGLE=1 where the site's weights fit the
  reference's budget: the C=320 32^2 sites): _block_kernel. On the card one
  cooperative launch of csrc/blockforms.cu's site_kernel over the same tiles.
- big-C (K6, under MVDF_BLOCK_BIGC=1: the C=1280 sites at 64 <= N <= 256):
  _pi_kernel, _bigattn_stream_kernel, _h2_kernel and _ff_stream_kernel. On
  the card K1, block.cu's LayerNorm and GEMM, and csrc/blockforms.cu's
  bigattn_kernel, which projects each head's q, k and v and attends without
  writing qkv to device memory.
The plain versions round where the TPU kernels round in bf16: every product
once (fp32 sum + fp32 bias), each residual add, the softmax probabilities,
and GEGLU's factors; the big-C form rounds h2 + FF once (its streamed fp32
accumulator). The card's GEMM epilogue rounds at the same points (`steps`).
No product goes to torch.matmul or cuBLAS on the card.

The GEMM and LayerNorm launchers here also serve K4 (ops/crossview.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.attention import launch_attention
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


# the one-kernel form's weight budget under MVDF_BLOCK_SINGLE=1 (the
# reference's _SINGLE_KERNEL_WEIGHT_BYTES; without the switch it is 0)
_SINGLE_KERNEL_WEIGHT_BYTES = 8 * 1024 * 1024


def single_kernel_weight_bytes() -> int:
    """The one-kernel form's weight budget, read when called."""
    return _SINGLE_KERNEL_WEIGHT_BYTES if os.environ.get("MVDF_BLOCK_SINGLE") else 0


def should_fuse_block(C: int, N: int, heads: int) -> bool:
    """The reference's gate (ops/block.py::should_fuse_block): the 32^2 C=320
    and 16^2 C=640 sites, and under MVDF_BLOCK_BIGC=1 (read when called) the
    C=1280 sites with 64 <= N <= 256."""
    if C % heads or (C // heads) % 8 or C % _GN_GROUPS:
        return False
    if C > _BIG_C_MIN:
        return bool(os.environ.get("MVDF_BLOCK_BIGC")) and C <= 1280 and 64 <= N <= 256 and N % 64 == 0
    if N % 128:
        return False
    return (C <= 384 and N <= 1024) or (C <= 768 and N <= 256)


def big_form_packs(B: int, N: int) -> bool:
    """Whether the reference's big-C form runs at this batch on its hardware
    (_pick_big_nb): it packs as many batch elements as fit 512 lanes, stepped
    down to a divisor of B, and needs the packed lanes to fill 128-lane tiles.
    Where they do not (B=1 at N=64, say) it computes its plain twin instead."""
    nb = max(1, min(B, 512 // max(N, 1)))
    while nb > 1 and B % nb:
        nb -= 1
    return (nb * N) % 128 == 0


def block_route(B: int, N: int, C: int, heads: int, inner: int):
    """The form the reference's _fwd_impl computes for a (B, N, C) site with a
    GEGLU inner width `inner`: "split", "single" or "big"; None where the site
    stays on the module path (the gate is off, or the big-C form falls back)."""
    if not should_fuse_block(C, N, heads):
        return None
    if C > _BIG_C_MIN:
        return "big" if big_form_packs(B, N) else None
    w_bytes = 2 * (6 * C * C + 2 * inner * C + C * inner)  # bf16 weights of the whole site
    return "single" if w_bytes <= single_kernel_weight_bytes() else "split"


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
         act: int = ACT_NONE, steps: bool = False, out=None):
    """csrc/block.cu GEMM: epilogue(a (M, K) @ w (N, K)^T) on CUDA tensors.

    epilogue: + bias, then GELU (act=1) or GEGLU over packed rows (act=2, see
    pack_geglu; output has N/2 columns), then * gate[col], + res1[row],
    + res2[row // res2_div], computed in fp32 and rounded once; with `steps`
    rounded to the output type after the bias, after each residual and at
    GEGLU's factors, as the TPU site kernels' bf16 operations round. `out`
    may alias `res1` (an in-place residual update)."""
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
        _f32(gate), int(act), int(steps), M, N, K, _lib.dtype_code(a.dtype),
    )
    return out


# ------------------------------------------------------------------ the site
def _mm(a, w, b=None):
    """The TPU kernels' _mm: a @ w^T of a and w in a's dtype, summed in fp32,
    + the fp32 bias, rounded once to a's dtype."""
    y = a.float() @ w.to(a.dtype).float().t()
    if b is not None:
        y = y + b.float()
    return y.to(a.dtype)


def _ln_plain(h, w, b, eps=_LN_EPS):
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = torch.clamp((hf * hf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return ((hf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(h.dtype)


def _attention_plain(q, k, v, scale: float):
    """The site kernels' attention on (B, N, H, dh): fp32 logits of the
    operands, exp((l - max) * scale) over its sum rounded to their dtype, PV
    summed in fp32 and rounded."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.exp((logits - logits.amax(-1, keepdim=True)) * scale)
    p = (p / p.sum(-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def qkv_attention_plain(ln1, qkv_w, heads: int):
    """Plain version of bigattn_kernel, and the qkv + attention stage of every
    form: q, k and v projected from ln1 (B, N, C) and rounded, then the site
    kernels' attention -> (B, N, C)."""
    B, N, C = ln1.shape
    dh = C // heads
    qkv = _mm(ln1, qkv_w).reshape(B, N, 3, heads, dh)
    return _attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh**-0.5).reshape(B, N, C)


def _gelu(x):
    """ops/crossview.py::_gelu as the site kernels apply it: (x * 0.5) *
    (1 + erf(x / sqrt 2)), the second factor rounded to x's dtype."""
    return (x * 0.5) * (1.0 + torch.erf(x.float() * 2**-0.5)).to(x.dtype)


def _site_plain(x_in, attn2_add, w: BlockWeights, heads: int, big: bool):
    dt = x_in.dtype
    x_gn = group_norm_plain(x_in, w.gn_w, w.gn_b, _GN_GROUPS, _GN_EPS)
    h0 = _mm(x_gn, w.pi_w, w.pi_b)
    attn = qkv_attention_plain(_ln_plain(h0, w.ln1_w, w.ln1_b), w.qkv_w, heads)
    a2 = attn2_add if attn2_add.ndim == 3 else attn2_add[:, None, :]
    h2 = (h0 + _mm(attn, w.out_w, w.out_b)) + a2.to(dt)
    g = _mm(_ln_plain(h2, w.ln3_w, w.ln3_b), w.g_w, w.g_b)
    inner = w.f_w.shape[1]
    y = g[..., :inner] * _gelu(g[..., inner:])
    if big:  # _ff_stream_kernel: h2 + f_b + the FF product in one fp32 sum, rounded once
        h3 = (h2.float() + w.f_b.float() + y.float() @ w.f_w.to(dt).float().t()).to(dt)
    else:
        h3 = h2 + _mm(y, w.f_w, w.f_b)
    return x_in + _mm(h3, w.po_w, w.po_b)


def transformer_block_plain(x_in, attn2_add, w: BlockWeights, heads: int):
    """Plain version of the split and one-kernel forms (they round at the same
    points): x_in (B, N, C) pre-GN site input, attn2_add a (B, C) row or
    (B, N, C) map -> x_in + proj_out(block(proj_in(GN(x_in))))."""
    return _site_plain(x_in, attn2_add, w, heads, big=False)


def transformer_block_big_plain(x_in, attn2_add, w: BlockWeights, heads: int):
    """Plain version of the big-C form: as transformer_block_plain, with
    h2 + FF rounded once."""
    return _site_plain(x_in, attn2_add, w, heads, big=True)


def _operands(x_in, attn2_add, w: BlockWeights):
    """x and attn2 contiguous in x's dtype, the res2 row divisor of attn2, the
    matrices cast to that dtype and GEGLU's rows packed."""
    B, N, C = x_in.shape
    dt = x_in.dtype
    if tuple(attn2_add.shape) not in ((B, C), (B, N, C)):
        raise ValueError(f"attn2 term {tuple(attn2_add.shape)} is neither ({B}, {C}) nor ({B}, {N}, {C})")
    cast = lambda t: t.to(dt).contiguous()
    g_w, g_b = pack_geglu(cast(w.g_w), w.g_b)
    mats = dict(pi_w=cast(w.pi_w), qkv_w=cast(w.qkv_w), out_w=cast(w.out_w), g_w=g_w, g_b=g_b,
                f_w=cast(w.f_w), po_w=cast(w.po_w))
    a2 = attn2_add.to(dt).contiguous()
    return x_in.contiguous(), a2, 1 if a2.ndim == 3 else N, w._replace(**mats)


def launch_transformer_block(x_in, attn2_add, w: BlockWeights, heads: int):
    """K3, the split form on the card: K1, LayerNorm, GEMMs and K2 (no counting)."""
    B, N, C = x_in.shape
    M, dh = B * N, C // heads
    x, a2, a2_div, w = _operands(x_in, attn2_add, w)
    xg = launch_group_norm(x, w.gn_w, w.gn_b, _GN_GROUPS, _GN_EPS).view(M, C)
    h0 = gemm(xg, w.pi_w, w.pi_b)
    qkv = gemm(layernorm(h0, w.ln1_w, w.ln1_b), w.qkv_w).view(B, N, 3, heads, dh)
    attn = launch_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh**-0.5).view(M, C)
    h2 = gemm(attn, w.out_w, w.out_b, res1=h0, res2=a2, res2_div=a2_div, steps=True)
    y = gemm(layernorm(h2, w.ln3_w, w.ln3_b), w.g_w, w.g_b, act=ACT_GEGLU, steps=True)
    h3 = gemm(y, w.f_w, w.f_b, res1=h2, steps=True)
    return gemm(h3, w.po_w, w.po_b, res1=x.view(M, C), steps=True).view(B, N, C)


_WORKSPACE: dict = {}
# K5's phases, in order; its block 0 stamps the device clock at the start and
# at the end of each
SITE_PHASES = ("gn_stats", "gn_apply", "proj_in", "ln1", "qkv", "attention", "out_proj", "ln3", "geglu", "ff",
               "proj_out")


def _site_workspace(B: int, N: int, C: int, inner: int, dtype, device):
    """K5's intermediates, allocated once per shape: GN mean and rstd per
    (batch, group), two (M, C) buffers, one (M, max(3C, inner)), and the
    phase stamps."""
    key = (B, N, C, inner, dtype, torch.device(device))
    if key not in _WORKSPACE:
        M = B * N
        _WORKSPACE[key] = (
            torch.empty(B * _GN_GROUPS * 2, dtype=torch.float32, device=device),
            torch.empty(M, C, dtype=dtype, device=device),
            torch.empty(M, C, dtype=dtype, device=device),
            torch.empty(M * max(3 * C, inner), dtype=dtype, device=device),
            torch.zeros(len(SITE_PHASES) + 1, dtype=torch.int64, device=device),
        )
    return _WORKSPACE[key]


def site_phase_ms(x_in, inner: int) -> dict:
    """Device ms of each phase of the last K5 launch at x_in's shape (B, N,
    C) and GEGLU width `inner`, from the stamps of its block 0 (waits for
    the device)."""
    B, N, C = x_in.shape
    t = _site_workspace(B, N, C, inner, x_in.dtype, x_in.device)[-1].tolist()
    return {name: (t[i + 1] - t[i]) / 1e6 for i, name in enumerate(SITE_PHASES)}


def launch_transformer_block_single(x_in, attn2_add, w: BlockWeights, heads: int):
    """K5, the one-kernel form on the card: one cooperative launch of
    csrc/blockforms.cu's site_kernel (no counting)."""
    B, N, C = x_in.shape
    inner = w.f_w.shape[1]
    x, a2, a2_div, w = _operands(x_in, attn2_add, w)
    out = torch.empty_like(x)
    _lib.call(
        "mvdf_block_single", x, a2, a2_div, _f32(w.gn_w), _f32(w.gn_b), w.pi_w, _f32(w.pi_b), _f32(w.ln1_w),
        _f32(w.ln1_b), w.qkv_w, w.out_w, _f32(w.out_b), _f32(w.ln3_w), _f32(w.ln3_b), w.g_w, _f32(w.g_b),
        w.f_w, _f32(w.f_b), w.po_w, _f32(w.po_b), out, *_site_workspace(B, N, C, inner, x.dtype, x.device),
        B, N, C, heads, inner, float(_GN_EPS), float(_LN_EPS), _lib.dtype_code(x.dtype),
    )
    return out


def launch_big_attention(ln1, qkv_w, heads: int):
    """csrc/blockforms.cu's bigattn_kernel: ln1 (B, N, C) and qkv_w (3C, C) in
    one dtype -> the (B, N, C) attention output."""
    B, N, C = ln1.shape
    if qkv_w.dtype != ln1.dtype or tuple(qkv_w.shape) != (3 * C, C):
        raise ValueError(f"qkv weights {tuple(qkv_w.shape)} {qkv_w.dtype} for ln1 {tuple(ln1.shape)} {ln1.dtype}")
    ln1 = ln1.contiguous()
    out = torch.empty_like(ln1)
    _lib.call("mvdf_big_attention", ln1, qkv_w.contiguous(), out, B, N, C, heads, float((C // heads) ** -0.5),
              _lib.dtype_code(ln1.dtype))
    return out


def launch_transformer_block_big(x_in, attn2_add, w: BlockWeights, heads: int):
    """K6, the big-C form on the card: K1, LayerNorm and GEMMs for
    _pi_kernel, bigattn_kernel for _bigattn_stream_kernel, the GEMM epilogue
    for _h2_kernel, LayerNorm and GEMMs for _ff_stream_kernel (no counting)."""
    B, N, C = x_in.shape
    M = B * N
    x, a2, a2_div, w = _operands(x_in, attn2_add, w)
    xg = launch_group_norm(x, w.gn_w, w.gn_b, _GN_GROUPS, _GN_EPS).view(M, C)
    h0 = gemm(xg, w.pi_w, w.pi_b)
    attn = launch_big_attention(layernorm(h0, w.ln1_w, w.ln1_b).view(B, N, C), w.qkv_w, heads).view(M, C)
    h2 = gemm(attn, w.out_w, w.out_b, res1=h0, res2=a2, res2_div=a2_div, steps=True)
    y = gemm(layernorm(h2, w.ln3_w, w.ln3_b), w.g_w, w.g_b, act=ACT_GEGLU, steps=True)
    h3 = gemm(y, w.f_w, w.f_b, res1=h2)  # one rounding of h2 + f_b + the product
    return gemm(h3, w.po_w, w.po_b, res1=x.view(M, C), steps=True).view(B, N, C)


# form -> (plain version, launcher, launch counter)
_FORMS = {
    "split": (transformer_block_plain, launch_transformer_block, "transformer_block"),
    "single": (transformer_block_plain, launch_transformer_block_single, "transformer_block_single"),
    "big": (transformer_block_big_plain, launch_transformer_block_big, "transformer_block_big"),
}


def transformer_block(x_in, attn2_add, w: BlockWeights, heads: int, form: str):
    """One transformer site in `form` (block_route): its CUDA kernels for CUDA
    tensors, its plain version for CPU tensors."""
    plain, launch, counter = _FORMS[form]
    if not x_in.is_cuda:
        return plain(x_in, attn2_add, w, heads)
    out = launch(x_in, attn2_add, w, heads)
    _lib.LAUNCHES[counter] += 1
    return out
