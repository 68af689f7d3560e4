"""K3, K5 and K6: the UNet transformer site (SpatialTransformer / ViewAligned
interior) in the three forms of mvdfusion_tpu/ops/block.py::_fwd_impl.

The site: site GroupNorm (eps 1e-6), proj_in, LN1, multi-head self-attention
with an fp32 softmax, out-proj, residual, + the precomputed attn2 term, LN3,
GEGLU with exact erf, FF out, residual, proj_out, + x_in. `block_route`
picks the form where the reference does:
- split (K3, the default): _attn_kernel + _ff_kernel. On the card a short
  sequence of hand-written kernels: K1 for the site GroupNorm, csrc/block.cu's
  LayerNorm, the site GEMM (`gemm`: csrc/gemm_sm90.cu's wgmma kernel in bf16)
  with a fused epilogue for every product (bias, residuals, the attn2 add,
  GEGLU), and K2 for the self-attention on the packed qkv.
- one kernel (K5, under MVDF_BLOCK_SINGLE=1 where the site's weights fit the
  reference's budget: the C=320 32^2 sites): _block_kernel. On the card one
  cooperative launch of csrc/blockforms.cu's site_kernel; in bf16 its six
  products are wgmma over TMA rings with the site GEMM's epilogue kinds
  (`site_gemm_phases`), reading the workspace and the prepared weights
  through tensor maps (SITE_MAPS).
- big-C (K6, under MVDF_BLOCK_BIGC=1: the C=1280 sites at 64 <= N <= 256):
  _pi_kernel, _bigattn_stream_kernel, _h2_kernel and _ff_stream_kernel. On
  the card K1, block.cu's LayerNorm, the site GEMM, and csrc/blockforms.cu's
  attention kernel (`launch_big_attention`), which projects each head's q,
  k and v and attends without writing qkv to device memory: on the tensor
  cores (wgmma, then mma.sync) at the 8^2 sites' shapes, on the CUDA cores
  at the others (`big_attention_route`).
The plain versions round where the TPU kernels round in bf16: every product
once (fp32 sum + fp32 bias), each residual add, the softmax probabilities,
and GEGLU's factors; the big-C form rounds h2 + FF once (its streamed fp32
accumulator). The card's GEMM epilogue rounds at the same points (`steps`).
No product goes to torch.matmul or cuBLAS on the card.

On the card the launchers read a site's weights prepared once
(`prepare_site_weights`: matrices in the activation dtype, qkv concatenated,
GEGLU's rows packed, vectors fp32); nn/unet.py keeps them on the site's
module (`prepared_site_weights`) until a parameter changes. The plain
versions read the parameters as they are (BlockWeights).

The GEMM and LayerNorm launchers here also serve K4 (ops/crossview.py).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.attention import MODE_PROBS, attention_plain, launch_attention
from mvdfusion_tpu_torch.ops.groupnorm import group_norm_plain, launch_group_norm

_LN_EPS = 1e-5
_GN_GROUPS = 32
_GN_EPS = 1e-6
_BIG_C_MIN = 768
ACT_NONE, ACT_GELU, ACT_GEGLU = 0, 1, 2
_GEGLU_HALF = 32  # half of each 64-column group of the GEMM's tiles
_SQRT_HALF = 0.7071067811865476


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


class PreparedSite(BlockWeights):
    """A site's weights as the card's kernels read them (prepare_site_weights):
    matrices in the activation dtype and contiguous, qkv_w the concatenated
    [Wq; Wk; Wv], g_w and g_b packed by pack_geglu, every vector fp32."""

    __slots__ = ()


# the one-kernel form's weight budget under MVDF_BLOCK_SINGLE=1 (the
# reference's _SINGLE_KERNEL_WEIGHT_BYTES; without the switch it is 0)
_SINGLE_KERNEL_WEIGHT_BYTES = 8 * 1024 * 1024


def single_kernel_weight_bytes() -> int:
    """The one-kernel form's weight budget, read when called."""
    return _SINGLE_KERNEL_WEIGHT_BYTES if os.environ.get("MVDF_BLOCK_SINGLE") else 0


def should_fuse_block(C: int, N: int, heads: int) -> bool:
    """The reference's gate (ops/block.py::should_fuse_block): the 32^2 C=320
    and 16^2 C=640 sites, and under MVDF_BLOCK_BIGC=1 (read when called) the
    C=1280 sites with 64 <= N <= 256; closed under the kernel-off switch."""
    if _lib.switched_off():
        return False
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


def layernorm(x, weight=None, bias=None, eps: float = _LN_EPS):
    """csrc/block.cu's LayerNorm over the last dim of a CUDA (M, C) tensor in
    bf16 or fp32, output in x's dtype: 16-byte rows, fp32 statistics in the
    reference's form (E[x^2] - mean^2 clamped at 0, as _ln_plain). Counts
    under "layernorm", and by (M, C) in _lib.LN_SHAPES."""
    _lib.no_graph("layernorm", x, weight, bias)
    C = x.shape[-1]
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the LayerNorm reads 16-byte vectors: x must be 16-byte aligned")
    y = torch.empty_like(x)
    M = x.numel() // C
    _lib.call("mvdf_layernorm", x, _f32(weight), _f32(bias), y, M, C, float(eps), _lib.dtype_code(x.dtype))
    _lib.LAUNCHES["layernorm"] += 1
    _lib.LN_SHAPES[(M, C)] += 1
    return y


def pack_geglu(w, b):
    """Reorder GEGLU rows [value; gate] so each 64-row group holds 32 value
    rows followed by their 32 gate rows (the GEMM's tiles are 64 columns, or
    a multiple of 64, wide)."""
    inner = w.shape[0] // 2
    if inner % _GEGLU_HALF:
        raise ValueError(f"GEGLU inner dim {inner} is not a multiple of {_GEGLU_HALF}")
    t = inner // _GEGLU_HALF
    wp = w.reshape(2, t, _GEGLU_HALF, w.shape[1]).transpose(0, 1).reshape(2 * inner, w.shape[1])
    bp = b.reshape(2, t, _GEGLU_HALF).transpose(0, 1).reshape(2 * inner)
    return wp.contiguous(), bp


def unpack_geglu(wp, bp):
    """The inverse of pack_geglu: rows [value; gate] again."""
    inner = wp.shape[0] // 2
    t = inner // _GEGLU_HALF
    w = wp.reshape(t, 2, _GEGLU_HALF, wp.shape[1]).transpose(0, 1).reshape(2 * inner, wp.shape[1])
    return w, bp.reshape(t, 2, _GEGLU_HALF).transpose(0, 1).reshape(2 * inner)


def _gelu_erf(v):
    """csrc/common.cuh's gelu_erf on fp32: (0.5 v) (1 + erf(v / sqrt 2))."""
    return 0.5 * v * (1.0 + torch.erf(v * _SQRT_HALF))


def gemm_plain(a, w, bias=None, *, out_dtype=None, res1=None, res2=None, res2_div: int = 1, gate=None,
               act: int = ACT_NONE, steps: bool = False, out=None):
    """Plain version of `gemm`: the product of a and w (in a's dtype) summed in
    fp32, then the kernels' epilogue in fp32 with their rounding points (the
    TPU kernels' _mm and bf16 adds as _site_plain computes them)."""
    odt = out.dtype if out is not None else (out_dtype or a.dtype)
    rnd = (lambda v: v.to(odt).float()) if steps and odt == torch.bfloat16 else (lambda v: v)
    v = a.float() @ w.to(a.dtype).float().t()
    if bias is not None:
        v = v + bias.float()
    if act == ACT_GEGLU:
        M, N = v.shape
        v = v.reshape(M, N // (2 * _GEGLU_HALF), 2, _GEGLU_HALF)
        val, g = v[:, :, 0].reshape(M, N // 2), v[:, :, 1].reshape(M, N // 2)
        if steps:
            g = rnd(g)
            v = rnd(val) * rnd(rnd(g * 0.5) * rnd(1.0 + torch.erf(g * _SQRT_HALF)))
        else:
            v = val * _gelu_erf(g)
    elif act == ACT_GELU:
        v = _gelu_erf(v)
    if gate is not None:
        v = v * gate.float()
    if res1 is not None:
        v = rnd(v) + res1.float().reshape(v.shape)
    if res2 is not None:
        rows = torch.arange(v.shape[0], device=v.device) // max(res2_div, 1)
        v = rnd(v) + res2.float().reshape(-1, v.shape[1])[rows]
    if out is None:
        return v.to(odt)
    out.copy_(v.reshape(out.shape))
    return out


def gemm_route(dtype, N: int, K: int, act: int = ACT_NONE) -> str:
    """The GEMM kernel for these operands, chosen explicitly: "sm90"
    (csrc/gemm_sm90.cu, wgmma) for bf16 with K % 8 == 0 and an output width
    that is a multiple of 4, "wmma" (block.cu's tile) for the other bf16
    shapes, "f32" (block.cu's CUDA-core tile) for fp32. Each counts under
    gemm_<route>."""
    if dtype == torch.float32:
        return "f32"
    n_out = N // 2 if act == ACT_GEGLU else N
    return "sm90" if K % 8 == 0 and n_out % 4 == 0 else "wmma"


GEMM_TILE_N = 128  # the wgmma kernel's tile width (csrc/gemm_sm90.cu)


def _weight_desc(w, bn: int):
    """W's tensor map in boxes of bn rows, made once per box height and kept
    on the tensor (a prepared weight lives as long as its site's cache)."""
    key = (w.data_ptr(), tuple(w.shape))
    maps = getattr(w, "_mvdf_tma", None)
    if maps is None or maps[0] != key:
        maps = (key, {})
        w._mvdf_tma = maps
    if bn not in maps[1]:
        maps[1][bn] = _lib.tma_desc(w, bn)
    return maps[1][bn]


def gemm(a, w, bias=None, *, out_dtype=None, res1=None, res2=None, res2_div: int = 1, gate=None,
         act: int = ACT_NONE, steps: bool = False, out=None, route: str | None = None):
    """The site GEMM: epilogue(a (M, K) @ w (N, K)^T); its CUDA kernel for CUDA
    tensors (`route`: gemm_route's choice, or "wmma" to take block.cu's tile
    for a bf16 comparison), gemm_plain for CPU tensors.

    epilogue: + bias, then GELU (act=1) or GEGLU over packed rows (act=2, see
    pack_geglu; output has N/2 columns), then * gate[col], + res1[row],
    + res2[row // res2_div], computed in fp32 and rounded once; with `steps`
    rounded to the output type after the bias, after each residual and at
    GEGLU's factors, as the TPU site kernels' bf16 operations round. `out`
    may alias `res1` (an in-place residual update). Under the kernel-off
    switch, gemm_plain."""
    if not _lib.launches(a):
        return gemm_plain(a, w, bias, out_dtype=out_dtype, res1=res1, res2=res2, res2_div=res2_div, gate=gate,
                          act=act, steps=steps, out=out)
    _lib.no_graph("gemm", a, w, bias, res1, res2, gate)
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
    route = route or gemm_route(a.dtype, N, K, act)
    if (route == "f32") != (a.dtype == torch.float32) or route not in ("sm90", "wmma", "f32"):
        raise ValueError(f"GEMM route {route!r} does not take {a.dtype} operands")
    n_out = N // 2 if act == ACT_GEGLU else N
    if out is None:
        out = torch.empty(M, n_out, dtype=out_dtype or a.dtype, device=a.device)
    for r, rows in ((res1, M), (res2, M // max(res2_div, 1))):
        if r is not None and (r.shape[-1] != n_out or r.numel() != rows * n_out):
            raise ValueError(f"residual {tuple(r.shape)} does not match ({rows}, {n_out})")
    epilogue = (_f32(bias), out, _lib.is_bf16(out), res1, _lib.is_bf16(res1), res2, _lib.is_bf16(res2),
                int(res2_div), _f32(gate), int(act), int(steps), M, N, K)
    if route == "sm90":
        if any(t is not None and t.data_ptr() % 16 for t in (epilogue[0], out, res1, res2, epilogue[8])):
            raise ValueError("the wgmma GEMM's epilogue reads and writes 16-byte vectors: bias, gate, out and "
                             "residuals 16-byte aligned")
        _lib.call("mvdf_gemm_sm90", a, _weight_desc(w, GEMM_TILE_N), *epilogue, GEMM_TILE_N)
    else:
        _lib.call("mvdf_gemm", a, w, *epilogue, _lib.dtype_code(a.dtype))
    _lib.LAUNCHES[f"gemm_{route}"] += 1
    _lib.GEMM_SHAPES[(route, M, N, K)] += 1
    return out


def prepare_site_weights(w: BlockWeights, dtype) -> PreparedSite:
    """w as the card's kernels read it, for activations of `dtype`: matrices
    cast to dtype and contiguous (aliases where they already are), GEGLU's
    rows and bias packed, vectors fp32."""
    mat = lambda t: t.detach().to(dtype).contiguous()
    vec = lambda t: t.detach().float().contiguous()
    g_w, g_b = pack_geglu(mat(w.g_w), vec(w.g_b))
    return PreparedSite(
        gn_w=vec(w.gn_w), gn_b=vec(w.gn_b), pi_w=mat(w.pi_w), pi_b=vec(w.pi_b), ln1_w=vec(w.ln1_w),
        ln1_b=vec(w.ln1_b), qkv_w=mat(w.qkv_w), out_w=mat(w.out_w), out_b=vec(w.out_b), ln3_w=vec(w.ln3_w),
        ln3_b=vec(w.ln3_b), g_w=g_w, g_b=g_b, f_w=mat(w.f_w), f_b=vec(w.f_b), po_w=mat(w.po_w), po_b=vec(w.po_b),
    )


def unprepared_site_weights(w: PreparedSite) -> BlockWeights:
    """The plain versions' view of prepared weights: GEGLU's rows and bias
    unpacked (exactly: a reordering), everything else as prepared."""
    g_w, g_b = unpack_geglu(w.g_w, w.g_b)
    return BlockWeights(*w)._replace(g_w=g_w, g_b=g_b)


def prepared_site_weights(owner, params, build, dtype) -> PreparedSite:
    """prepare_site_weights(build(), dtype), kept on `owner` (the site's
    module) until the data pointer, version or dtype of one of `params`
    (every parameter that `build` reads) changes, or dtype does."""
    return _lib.cached(owner, "_mvdf_site_weights", params, dtype, lambda: prepare_site_weights(build(), dtype))


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


def qkv_attention_plain(ln1, qkv_w, heads: int):
    """Plain version of K6's attention kernel, and the qkv + attention stage
    of every form: q, k and v projected from ln1 (B, N, C) and rounded, then
    the site kernels' attention -> (B, N, C)."""
    B, N, C = ln1.shape
    dh = C // heads
    qkv = _mm(ln1, qkv_w).reshape(B, N, 3, heads, dh)
    return attention_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh**-0.5, MODE_PROBS).reshape(B, N, C)


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
    """x and attn2 contiguous in x's dtype, the res2 row divisor of attn2, and
    the weights prepared for that dtype (as they come if already prepared)."""
    _lib.no_graph("transformer site", x_in, attn2_add, *w)
    B, N, C = x_in.shape
    dt = x_in.dtype
    if tuple(attn2_add.shape) not in ((B, C), (B, N, C)):
        raise ValueError(f"attn2 term {tuple(attn2_add.shape)} is neither ({B}, {C}) nor ({B}, {N}, {C})")
    if not isinstance(w, PreparedSite):
        w = prepare_site_weights(w, dt)
    elif w.pi_w.dtype != dt:
        raise ValueError(f"site weights prepared for {w.pi_w.dtype}, activations in {dt}")
    a2 = attn2_add.to(dt).contiguous()
    return x_in.contiguous(), a2, 1 if a2.ndim == 3 else N, w


def launch_transformer_block(x_in, attn2_add, w: BlockWeights, heads: int):
    """K3, the split form on the card: K1, LayerNorm, GEMMs and K2, on the
    weights prepared (as they come if already prepared). Counts its K2 launch
    under attention_site_n{N}; the GEMMs count themselves (gemm_<route>) and
    K3's own count is transformer_block's."""
    B, N, C = x_in.shape
    M, dh = B * N, C // heads
    x, a2, a2_div, w = _operands(x_in, attn2_add, w)
    xg = launch_group_norm(x, w.gn_w, w.gn_b, _GN_GROUPS, _GN_EPS).view(M, C)
    h0 = gemm(xg, w.pi_w, w.pi_b)
    qkv = gemm(layernorm(h0, w.ln1_w, w.ln1_b), w.qkv_w).view(B, N, 3, heads, dh)
    attn = launch_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dh**-0.5, MODE_PROBS).view(M, C)
    _lib.LAUNCHES[f"attention_site_n{N}"] += 1  # K2 inside K3, by sequence length
    h2 = gemm(attn, w.out_w, w.out_b, res1=h0, res2=a2, res2_div=a2_div, steps=True)
    y = gemm(layernorm(h2, w.ln3_w, w.ln3_b), w.g_w, w.g_b, act=ACT_GEGLU, steps=True)
    h3 = gemm(y, w.f_w, w.f_b, res1=h2, steps=True)
    return gemm(h3, w.po_w, w.po_b, res1=x.view(M, C), steps=True).view(B, N, C)


_WORKSPACE: dict = {}
# K5's phases, in order; its block 0 stamps the device clock at the start and
# at the end of each
SITE_PHASES = ("gn_stats", "gn_apply", "proj_in", "ln1", "qkv", "attention", "out_proj", "ln3", "geglu", "ff",
               "proj_out")
SITE_GN_ROWS = 32  # rows of one of K5's bf16 GroupNorm tiles (csrc/blockforms.cu)
SITE_A_BOX, SITE_W_BOX = 64, GEMM_TILE_N  # K5's tile: 64 rows of A against 128 rows of W
# K5's bf16 tensor maps, in csrc/blockforms.cu::SiteMaps' order: the
# workspace's A operands, then the prepared weights
SITE_MAPS = ("A", "H", "big", "pi_w", "qkv_w", "out_w", "g_w", "f_w", "po_w")


class SiteGemm(NamedTuple):
    """One of K5's six products: epilogue(a (M, K) @ w (N, K)^T) -> out, a and
    out named as K5's workspace names them ("A", "H", "big", "x", "out"),
    w and bias as PreparedSite names them, `kind` the epilogue's pass 2
    (csrc/gemm.cuh::epilogue_kind: "bias", "res1", "res2" or "geglu")."""

    name: str
    a: str
    w: str
    M: int
    N: int
    K: int
    bias: str | None
    res1: str | None
    res2: str | None
    kind: str
    out: str


def site_gemm_phases(B: int, N: int, C: int, inner: int) -> tuple:
    """K5's products in the order its phases run them (site_kernel): the six
    products of launch_transformer_block, with the same epilogue kinds, so K5
    rounds where K3 rounds."""
    M = B * N
    return (
        SiteGemm("proj_in", "A", "pi_w", M, C, C, "pi_b", None, None, "bias", "H"),
        SiteGemm("qkv", "A", "qkv_w", M, 3 * C, C, None, None, None, "bias", "big"),
        SiteGemm("out_proj", "A", "out_w", M, C, C, "out_b", "H", "a2", "res2", "H"),
        SiteGemm("geglu", "A", "g_w", M, 2 * inner, C, "g_b", None, None, "geglu", "big"),
        SiteGemm("ff", "big", "f_w", M, C, inner, "f_b", "H", None, "res1", "H"),
        SiteGemm("proj_out", "H", "po_w", M, C, C, "po_b", "x", None, "res1", "out"),
    )


def _site_workspace(B: int, N: int, C: int, inner: int, dtype, device):
    """K5's intermediates, allocated once per shape: the GN statistics (fp32:
    mean and rstd per (batch, group); bf16: partial sums per (batch, 32-row
    chunk, group)), two (M, C) buffers, one (M, max(3C, inner)), and the
    phase stamps followed by the launch's number of blocks."""
    key = (B, N, C, inner, dtype, torch.device(device))
    if key not in _WORKSPACE:
        M = B * N
        chunks = -(-N // SITE_GN_ROWS)
        _WORKSPACE[key] = (
            torch.empty(B * chunks * _GN_GROUPS * 2, dtype=torch.float32, device=device),
            torch.empty(M, C, dtype=dtype, device=device),
            torch.empty(M, C, dtype=dtype, device=device),
            torch.empty(M * max(3 * C, inner), dtype=dtype, device=device),
            torch.zeros(len(SITE_PHASES) + 2, dtype=torch.int64, device=device),
        )
    return _WORKSPACE[key]


_WORKSPACE_MAPS: dict = {}


def _site_workspace_maps(B: int, N: int, C: int, inner: int, device) -> bytes:
    """The tensor maps of K5's bf16 workspace operands A, H (M, C) and big
    (M, inner), in 64-row boxes, made once per workspace (SITE_MAPS' first
    three)."""
    key = (B, N, C, inner, torch.device(device))
    if key not in _WORKSPACE_MAPS:
        _, A, H, big, _ = _site_workspace(B, N, C, inner, torch.bfloat16, device)
        M = B * N
        ops = {"A": A, "H": H, "big": big[: M * inner].view(M, inner)}
        _WORKSPACE_MAPS[key] = b"".join(bytes(_lib.tma_desc(ops[n], SITE_A_BOX)) for n in SITE_MAPS[:3])
    return _WORKSPACE_MAPS[key]


def site_phase_ms(x_in, inner: int) -> dict:
    """Device ms of each phase of the last K5 launch at x_in's shape (B, N,
    C) and GEGLU width `inner`, from the stamps of its block 0 (waits for
    the device)."""
    B, N, C = x_in.shape
    t = _site_workspace(B, N, C, inner, x_in.dtype, x_in.device)[-1].tolist()
    return {name: (t[i + 1] - t[i]) / 1e6 for i, name in enumerate(SITE_PHASES)}


def site_grid_blocks(x_in, inner: int) -> int:
    """Blocks of the last K5 launch at x_in's shape (B, N, C) and GEGLU width
    `inner`: the SMs times the blocks an SM holds (waits for the device)."""
    B, N, C = x_in.shape
    return int(_site_workspace(B, N, C, inner, x_in.dtype, x_in.device)[-1][-1])


def launch_transformer_block_single(x_in, attn2_add, w: BlockWeights, heads: int):
    """K5, the one-kernel form on the card: one cooperative launch of
    csrc/blockforms.cu's site_kernel (no counting). In bf16 its products
    read the workspace's and the prepared weights' tensor maps."""
    B, N, C = x_in.shape
    inner = w.f_w.shape[1]
    x, a2, a2_div, w = _operands(x_in, attn2_add, w)
    maps = None
    if x.dtype == torch.bfloat16:
        if C % 64 or inner % 64:
            raise ValueError(f"K5 in bf16 reads 64-column boxes: C={C}, inner={inner}")
        wmaps = b"".join(bytes(_weight_desc(getattr(w, n), SITE_W_BOX)) for n in SITE_MAPS[3:])
        maps = ctypes.create_string_buffer(_site_workspace_maps(B, N, C, inner, x.device) + wmaps)
    out = torch.empty_like(x)
    _lib.call(
        "mvdf_block_single", x, a2, a2_div, w.gn_w, w.gn_b, w.pi_w, w.pi_b, w.ln1_w, w.ln1_b, w.qkv_w, w.out_w,
        w.out_b, w.ln3_w, w.ln3_b, w.g_w, w.g_b, w.f_w, w.f_b, w.po_w, w.po_b, out,
        *_site_workspace(B, N, C, inner, x.dtype, x.device), maps,
        B, N, C, heads, inner, float(_GN_EPS), float(_LN_EPS), _lib.dtype_code(x.dtype),
    )
    return out


BIG_ATTN_DH = 160  # the head width of the tensor-core K6 tile (csrc/blockforms.cu::bigattn_sm90_kernel)
_SMS: dict = {}


def big_attention_consumers(B: int, N: int, heads: int, sms: int) -> int:
    """The tensor-core K6 tile's consumer warpgroups a block: two at N = 128
    (a batch element a block); at N = 64 one (a batch element a block, heads
    x B blocks) while those blocks fit one wave of the card's `sms` SMs (one
    block an SM), else two (two batch elements a block, half the blocks):
    the faster of the two at the flagship's and the eval path's CFG batch
    (chip_smoke.py --k5-sweep; PERF.md)."""
    if N == 128:
        return 2
    return 1 if heads * B <= sms else 2


def big_attention_route(dtype, N: int, C: int, heads: int) -> str:
    """K6's attention kernel for these operands, by shape: "sm90"
    (bigattn_sm90_kernel: bf16, dh = 160, N = 64 or 128, the 8^2 sites) or
    "cores" (bigattn_kernel: fp32, and bf16 at the other shapes, N = 192
    and 256 from the 512^2 stretch)."""
    ok = dtype == torch.bfloat16 and C % heads == 0 and C // heads == BIG_ATTN_DH and C % 64 == 0
    return "sm90" if ok and N in (64, 128) else "cores"


def big_attention_plan(B: int, N: int, consumers: int, route: str = "sm90") -> list:
    """The blocks of one head of K6's attention kernel, in grid order: for
    each, the (batch, first token row, rows) of each 64-row slice that one
    consumer warpgroup projects and attends (sm90: 64 x consumers rows a
    block, N = 64 or 128; rows past B N are dropped), or of each 64-query
    slab (cores: one block a batch element, its N keys)."""
    if route == "cores":
        return [[(b, n0, min(64, N - n0)) for n0 in range(0, N, 64)] for b in range(B)]
    rows = 64 * consumers
    if N not in (64, 128) or rows % N:
        raise ValueError(f"the tensor-core K6 tile takes N = 64 or 128 with whole batch elements: N={N}, "
                         f"{consumers} warpgroups")
    plan = []
    for row0 in range(0, B * N, rows):
        plan.append([(r // N, r % N, 64) for r in range(row0, min(row0 + rows, B * N), 64)])
    return plan


def big_attention_tiles_plain(ln1, qkv_w, heads: int, consumers: int = 2, route: str | None = None):
    """The attention kernel's tile order on the CPU: for each head and each
    block of big_attention_plan, the block's q, k and v products rounded as
    the tile rounds them, then each slice's queries against its batch
    element's keys (attention_plain's probs form). Equal to
    qkv_attention_plain."""
    B, N, C = ln1.shape
    dh = C // heads
    route = route or big_attention_route(ln1.dtype, N, C, heads)
    out = torch.empty_like(ln1)
    for h in range(heads):
        wq, wk, wv = (qkv_w[p * C + h * dh : p * C + (h + 1) * dh] for p in range(3))
        for block in big_attention_plan(B, N, consumers, route):
            batches = sorted({b for b, _, _ in block})
            kv = {b: (_mm(ln1[b], wk), _mm(ln1[b], wv)) for b in batches}
            for b, n0, rows in block:
                q = _mm(ln1[b, n0 : n0 + rows], wq)
                k, v = kv[b]
                o = attention_plain(q[None, :, None], k[None, :, None], v[None, :, None], dh**-0.5, MODE_PROBS)
                out[b, n0 : n0 + rows, h * dh : (h + 1) * dh] = o[0, :, 0]
    return out


def launch_big_attention(ln1, qkv_w, heads: int, consumers: int | None = None):
    """csrc/blockforms.cu's K6 attention: ln1 (B, N, C) and qkv_w (3C, C) in
    one dtype -> the (B, N, C) attention output; bigattn_sm90_kernel or
    bigattn_kernel as big_attention_route says (`consumers`: the sm90
    tile's warpgroups a block, by default big_attention_consumers'). Counts
    under "big_attention"."""
    _lib.no_graph("launch_big_attention", ln1, qkv_w)
    B, N, C = ln1.shape
    if qkv_w.dtype != ln1.dtype or tuple(qkv_w.shape) != (3 * C, C):
        raise ValueError(f"qkv weights {tuple(qkv_w.shape)} {qkv_w.dtype} for ln1 {tuple(ln1.shape)} {ln1.dtype}")
    ln1 = ln1.contiguous()
    qkv_w = qkv_w.contiguous()
    out = torch.empty_like(ln1)
    desc, cons = None, 0
    if big_attention_route(ln1.dtype, N, C, heads) == "sm90":
        if ln1.data_ptr() % 16 or qkv_w.data_ptr() % 16:
            raise ValueError("the tensor-core K6 tile reads ln1 and qkv_w through TMA: 16-byte aligned")
        desc = _weight_desc(qkv_w, BIG_ATTN_DH)
        if ln1.device not in _SMS:
            _SMS[ln1.device] = torch.cuda.get_device_properties(ln1.device).multi_processor_count
        cons = consumers or big_attention_consumers(B, N, heads, _SMS[ln1.device])
    _lib.call("mvdf_big_attention", ln1, qkv_w, desc, out, B, N, C, heads, float((C // heads) ** -0.5),
              _lib.dtype_code(ln1.dtype), cons)
    _lib.LAUNCHES["big_attention"] += 1
    return out


def launch_transformer_block_big(x_in, attn2_add, w: BlockWeights, heads: int):
    """K6, the big-C form on the card: K1, LayerNorm and GEMMs for
    _pi_kernel, launch_big_attention for _bigattn_stream_kernel, the GEMM epilogue
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


def transformer_block(x_in, attn2_add, w: BlockWeights, heads: int, form: str, prepared: PreparedSite | None = None):
    """One transformer site in `form` (block_route): its CUDA kernels where
    _lib.launches, else its plain version. `w` as the parameters are
    (BlockWeights, the gradient's path to them) or prepared (PreparedSite);
    the kernels read `prepared` where given, else `w`. The gradient is the
    plain version's on `w`."""
    plain, launch, counter = _FORMS[form]
    unprep = lambda t: unprepared_site_weights(PreparedSite(*t)) if isinstance(w, PreparedSite) else BlockWeights(*t)
    if not _lib.launches(x_in):
        return plain(x_in, attn2_add, unprep(w), heads)
    kw = w if prepared is None else prepared
    out = _lib.with_plain_backward(lambda x, a2, *_: launch(x, a2, kw, heads),
                                   lambda x, a2, *t: plain(x, a2, unprep(t), heads), x_in, attn2_add, *w)
    _lib.LAUNCHES[counter] += 1
    return out
