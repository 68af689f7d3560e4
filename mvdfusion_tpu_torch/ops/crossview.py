"""K4: cross-view aggregation, the GridAttn hot path.

Replaces mvdfusion_tpu/ops/crossview.py::_crossview_fwd_impl in both its
forms. For each query point and each of V views: a bilinear gather from the
view's pre-projected map at the negated NDC coordinates, + the geometric
embedding (ray direction, Plucker moment, depth and their sin/cos at
omega0 * 2^k, through `kall`), + mask * kmask + b_acc, exact GELU; then the
adaLN-Zero DiT layers across V (modulation precomputed once per step), a
softmax pool over V and final_layer.

The reference routes by the size of the V projected maps (`crossview_route`,
its exact byte test): up to 6 MiB the single-kernel form (_kernel), above it
the two-phase form (_gather_kernel, then _dit_kernel), whose phase 1 rounds
the gathered tokens to the maps' dtype before b_acc and the GELU. In bf16 at
32^2 latents and hid 256 that is V >= 13 views, so the 15-target evaluation
takes the two-phase form on every step.

On the card (see csrc/crossview.cu for the design): the gather kernel writes
fp32 (N, V, hid) tokens (single form), or tokens in the maps' dtype that a
second elementwise kernel turns into fp32 GELU(tok + b_acc) (two-phase form);
each DiT layer is then LayerNorm -> GEMM (qkv, fp32) -> per-point view
attention -> GEMM with a gated in-place residual -> LayerNorm -> GEMM + GELU
-> GEMM with a gated residual; then the pool kernel and the final GEMM. The
residual stream stays fp32 as in the reference kernels. The GEMMs are
ops/block.py's site GEMM (csrc/gemm_sm90.cu in bf16). The kernels read the
weights prepared once (`prepare_crossview_weights`: matrices in the maps'
dtype, vectors fp32); nn/viewattn.py keeps them on its module
(`prepared_crossview_weights`) until a parameter changes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from mvdfusion_tpu_torch.geometry.gridsample import bilinear_gather
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.block import ACT_GELU, gemm, layernorm

_DIT_LN_EPS = 1e-6


class AggregatorWeights(NamedTuple):
    """DiT weights per layer (nn.Linear (out, in) layout) + pool/output heads."""

    qkv_w: Sequence[torch.Tensor]  # L x (3*hid, hid)
    qkv_b: Sequence[torch.Tensor]  # L x (3*hid,)
    proj_w: Sequence[torch.Tensor]
    proj_b: Sequence[torch.Tensor]
    fc1_w: Sequence[torch.Tensor]  # L x (mlp, hid)
    fc1_b: Sequence[torch.Tensor]
    fc2_w: Sequence[torch.Tensor]  # L x (hid, mlp)
    fc2_b: Sequence[torch.Tensor]
    mods: torch.Tensor  # (L, 6, hid) fp32 adaLN modulation (shared t)
    wl_w: torch.Tensor  # (1, hid) weight_layer
    wl_b: torch.Tensor  # (1,)
    fin_w: torch.Tensor  # (out_dim, hid)
    fin_b: torch.Tensor


class PreparedAggregator(AggregatorWeights):
    """AggregatorWeights as the card's kernels read them
    (prepare_crossview_weights): matrices in the maps' dtype and contiguous,
    biases fp32; the same layout, so the plain versions read them too."""

    __slots__ = ()


class GeoWeights(NamedTuple):
    """The geometric token parts' projection, rows matching geo_aug's
    [raw 7 | sin freq-major | cos freq-major] features."""

    kall: torch.Tensor  # (7 * (1 + 2 * nh), hid)
    kmask: torch.Tensor  # (hid,)


def should_fuse_crossview(V: int, H: int, W: int, hid: int) -> bool:
    """The reference's gate (ops/crossview.py::should_fuse_crossview; the
    top-k view window it also excludes is not ported)."""
    return V <= 16 and H * W <= 8192 and hid <= 512


# the reference's budget for all V projected maps resident in one kernel
# (ops/crossview.py:559); above it the two-phase form
_SINGLE_KERNEL_MAPS_BYTES = 6 * 1024 * 1024


def crossview_route(V: int, H: int, W: int, hid: int, dtype: torch.dtype) -> str:
    """The form K4 takes, "single" or "two_phase", by the reference's test
    V * H * W * hid * itemsize <= _SINGLE_KERNEL_MAPS_BYTES (:583)."""
    return "single" if V * H * W * hid * dtype.itemsize <= _SINGLE_KERNEL_MAPS_BYTES else "two_phase"


def geo_aug(pts, centers, freqs):
    """(V, N, 7 * (1 + 2 * nh)) fp32: [dir | o x dir | depth] raw, then sin
    and cos of each feature times each frequency, frequency-major."""
    dirs = pts[None].float() - centers[:, None].float()
    depth = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dirn = dirs / torch.clamp(depth, min=1e-12)
    mom = torch.cross(centers[:, None].float().expand_as(dirn), dirn, dim=-1)
    X = torch.cat([dirn, mom, depth], dim=-1)
    S = torch.cat([X * f for f in freqs], dim=-1)
    return torch.cat([X, torch.sin(S), torch.cos(S)], dim=-1)


def _layernorm_plain(x, eps=_DIT_LN_EPS):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def gather_tokens_plain(xy, pts, centers, mask, maps_p, kg: GeoWeights, freqs: tuple):
    """(V, N, hid) fp32 tokens before b_acc: the bilinear gather + geo_aug @
    kall + mask * kmask, the hat weights and geo_aug rounded to maps_p's
    dtype before their products as in both reference forms (:171,:174 and
    :429,:432); sums in fp32."""
    dt = maps_p.dtype
    geo = geo_aug(pts, centers, freqs).to(dt).float() @ kg.kall.to(dt).float()
    return bilinear_gather(maps_p, xy) + geo + mask.float()[:, None, None] * kg.kmask.float()


def gather_tokens_bound(xy, pts, centers, mask, maps_p, kg: GeoWeights, freqs: tuple, flips: int = 2):
    """(V, N, hid) fp32 bound on the difference of two fp32 evaluations of
    gather_tokens_plain's sum, such as the gather kernel's and this file's:
    n * 2^-23 * sum|terms| for its n = G + 5 terms summed in any order (the
    products of bf16 operands are exact in fp32), plus `flips` one-ulp
    changes of the largest bf16-rounded geometric product, where the two
    evaluations' fp32 features (sin/cos, sqrt, division in other forms)
    straddle a bf16 rounding boundary. For tokens in maps_p's dtype add one
    ulp of that dtype for their final rounding."""
    dt = maps_p.dtype
    aug = geo_aug(pts, centers, freqs).to(dt).float().abs()
    kall = kg.kall.to(dt).float().abs()
    terms = bilinear_gather(maps_p.abs(), xy) + aug @ kall + (mask.float()[:, None, None] * kg.kmask.float()).abs()
    bound = (kall.shape[0] + 5) * 2.0**-23 * terms
    if flips and dt != torch.float32:
        top = torch.zeros_like(terms)
        for g in range(kall.shape[0]):
            torch.maximum(top, aug[..., g : g + 1] * kall[g], out=top)
        bound += flips * torch.finfo(dt).eps * top
    return bound


def _dit_pool_plain(x, w: AggregatorWeights, heads: int, dt):
    """x (N, V, hid) fp32 GELU'd tokens -> (N, out_dim) in dt: the DiT
    layers across V, the softmax pool and final_layer (the reference's
    _dit_pool, shared by both forms)."""
    N, V, hid = x.shape
    dh = hid // heads

    def mm(a, k, b=None):  # k in (out, in) layout
        y = a.to(dt).float() @ k.to(dt).float().t()
        return y if b is None else y + b.float()

    xf = x.reshape(N * V, hid)
    for l in range(len(w.qkv_w)):
        m = w.mods[l].float()
        h = _layernorm_plain(xf) * (1 + m[1]) + m[0]
        q, k, v = (a.reshape(N, V, heads, dh) for a in mm(h, w.qkv_w[l], w.qkv_b[l]).chunk(3, dim=-1))
        p = torch.softmax(torch.einsum("nvhd,nwhd->nhvw", q, k) * dh**-0.5, dim=-1)
        att = torch.einsum("nhvw,nwhd->nvhd", p, v).reshape(N * V, hid)
        xf = xf + m[2] * mm(att, w.proj_w[l], w.proj_b[l])
        h = _layernorm_plain(xf) * (1 + m[4]) + m[3]
        h = F.gelu(mm(h, w.fc1_w[l], w.fc1_b[l]))
        xf = xf + m[5] * mm(h, w.fc2_w[l], w.fc2_b[l])
    ww = torch.softmax(mm(xf, w.wl_w, w.wl_b).reshape(N, V), dim=-1)
    pooled = (xf.reshape(N, V, hid) * ww[..., None]).sum(dim=1)
    return mm(pooled, w.fin_w, w.fin_b).to(dt)


def crossview_plain(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                    heads: int, freqs: tuple):
    """Plain PyTorch version of the single form. xy (V, N, 2) negated NDC,
    pts (N, 3), centers (V, 3), mask (V,), b_acc (N, hid), maps_p
    (V, H, W, hid) -> (N, out_dim) in maps_p's dtype. Products take
    dt-rounded operands with fp32 results; the residual stream and all
    sums are fp32."""
    tok = gather_tokens_plain(xy, pts, centers, mask, maps_p, kg, freqs)
    x = F.gelu(tok.transpose(0, 1) + b_acc.float()[:, None, :])  # (N, V, hid)
    return _dit_pool_plain(x, w, heads, maps_p.dtype)


def crossview_two_phase_plain(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                              heads: int, freqs: tuple):
    """Plain PyTorch version of the two-phase form: phase 1's tokens are
    rounded to maps_p's dtype (the reference's `tok.astype(out_ref.dtype)`,
    :436) before phase 2 adds b_acc in fp32 and applies the GELU (:454).
    Identical to crossview_plain in fp32."""
    tok = gather_tokens_plain(xy, pts, centers, mask, maps_p, kg, freqs).to(maps_p.dtype)
    x = F.gelu(tok.float().transpose(0, 1) + b_acc.float()[:, None, :])
    return _dit_pool_plain(x, w, heads, maps_p.dtype)


def prepare_crossview_weights(kg: GeoWeights, w: AggregatorWeights, dtype):
    """(kg, w) as the card's kernels read them for maps of `dtype`: matrices
    cast to dtype and contiguous (aliases where they already are), vectors
    fp32; w's per-step mods as they come. Prepared weights pass unchanged."""
    mat = lambda t: t.detach().to(dtype).contiguous()
    vec = lambda t: t.detach().float().contiguous()
    if not isinstance(w, PreparedAggregator):
        w = PreparedAggregator(
            qkv_w=[mat(t) for t in w.qkv_w], qkv_b=[vec(t) for t in w.qkv_b],
            proj_w=[mat(t) for t in w.proj_w], proj_b=[vec(t) for t in w.proj_b],
            fc1_w=[mat(t) for t in w.fc1_w], fc1_b=[vec(t) for t in w.fc1_b],
            fc2_w=[mat(t) for t in w.fc2_w], fc2_b=[vec(t) for t in w.fc2_b],
            mods=w.mods, wl_w=mat(w.wl_w), wl_b=vec(w.wl_b), fin_w=mat(w.fin_w), fin_b=vec(w.fin_b),
        )
    elif w.fin_w.dtype != dtype:
        raise ValueError(f"aggregator weights prepared for {w.fin_w.dtype}, maps in {dtype}")
    return GeoWeights(kall=mat(kg.kall), kmask=vec(kg.kmask)), w


def prepared_crossview_weights(owner, params, build, dtype):
    """prepare_crossview_weights(*build(), dtype), kept on `owner` (GridAttn's
    module) until the data pointer, version or dtype of one of `params`
    (every parameter that `build` reads) changes, or dtype does."""
    return _lib.cached(owner, "_mvdf_crossview_weights", params, dtype,
                       lambda: prepare_crossview_weights(*build(), dtype))


def _launch_dit_pool(x, N: int, V: int, w: PreparedAggregator, heads: int, dt):
    """x (N * V, hid) fp32 GELU'd tokens, updated in place -> (N, out_dim)."""
    hid = x.shape[-1]
    code = _lib.dtype_code(dt)
    att = torch.empty(N * V, hid, dtype=dt, device=x.device)
    for l in range(len(w.qkv_w)):
        m = w.mods[l].float()
        h = layernorm(x, 1 + m[1], m[0], _DIT_LN_EPS, out_dtype=dt)
        qkv = gemm(h, w.qkv_w[l], w.qkv_b[l], out_dtype=torch.float32)
        _lib.call("mvdf_cv_attention", qkv, att, N, V, heads, hid // heads,
                  float((hid // heads) ** -0.5), code)
        gemm(att, w.proj_w[l], w.proj_b[l], gate=m[2], res1=x, out=x)
        h = layernorm(x, 1 + m[4], m[3], _DIT_LN_EPS, out_dtype=dt)
        h = gemm(h, w.fc1_w[l], w.fc1_b[l], act=ACT_GELU)
        gemm(h, w.fc2_w[l], w.fc2_b[l], gate=m[5], res1=x, out=x)
    pooled = torch.empty(N, hid, dtype=dt, device=x.device)
    _lib.call("mvdf_cv_pool", x, w.wl_w.reshape(-1), w.wl_b.reshape(-1), pooled, N, V, hid, code)
    return gemm(pooled, w.fin_w, w.fin_b)


def launch_crossview(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                     heads: int, freqs: tuple):
    """K4's single form on the card: gather, DiT layers, pool and output
    GEMM (no counting); kg and w as the parameters are or prepared."""
    V, N, _ = xy.shape
    _, H, W_, hid = maps_p.shape
    dt = maps_p.dtype
    kg, w = prepare_crossview_weights(kg, w, dt)
    c = lambda t: t.to(dt).contiguous()
    f = lambda t: t.float().contiguous()
    x = torch.empty(N * V, hid, dtype=torch.float32, device=maps_p.device)
    freq_t = torch.tensor(freqs, dtype=torch.float32, device=maps_p.device)
    _lib.call(
        "mvdf_cv_gather", f(xy), f(pts), f(centers), f(mask),
        c(b_acc), c(maps_p), kg.kall, kg.kmask,
        freq_t, len(freqs), x, V, N, H, W_, hid, _lib.dtype_code(dt),
    )
    return _launch_dit_pool(x, N, V, w, heads, dt)


def launch_gather_tokens(xy, pts, centers, mask, maps_p, kg: GeoWeights, freqs: tuple):
    """The two-phase form's phase 1 on the card: (N, V, hid) tokens in
    maps_p's dtype, point-major (the transpose of gather_tokens_plain)."""
    V, N, _ = xy.shape
    _, H, W_, hid = maps_p.shape
    dt = maps_p.dtype
    tok = torch.empty(N, V, hid, dtype=dt, device=maps_p.device)
    freq_t = torch.tensor(freqs, dtype=torch.float32, device=maps_p.device)
    _lib.call(
        "mvdf_cv_gather_tokens", xy.float().contiguous(), pts.float().contiguous(),
        centers.float().contiguous(), mask.float().contiguous(), maps_p.contiguous(),
        kg.kall.to(dt).contiguous(), kg.kmask.float().contiguous(),
        freq_t, len(freqs), tok, V, N, H, W_, hid, _lib.dtype_code(dt),
    )
    return tok


def launch_crossview_two_phase(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                               heads: int, freqs: tuple):
    """K4's two-phase form on the card: phase-1 tokens in maps_p's dtype,
    GELU(tok + b_acc) into the fp32 stream, then the same DiT, pool and
    output GEMM as the single form (no counting); kg and w as the parameters
    are or prepared."""
    V, N, _ = xy.shape
    hid = maps_p.shape[-1]
    dt = maps_p.dtype
    kg, w = prepare_crossview_weights(kg, w, dt)
    tok = launch_gather_tokens(xy, pts, centers, mask, maps_p, kg, freqs)
    x = torch.empty(N * V, hid, dtype=torch.float32, device=maps_p.device)
    _lib.call("mvdf_cv_token_gelu", tok, b_acc.to(dt).contiguous(), x, N, V, hid, _lib.dtype_code(dt))
    return _launch_dit_pool(x, N, V, w, heads, dt)


def crossview_aggregate(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                        heads: int, freqs: tuple):
    """Pooled, projected frustum features (N, out_dim) by the reference's
    route: the CUDA kernels of that form for CUDA tensors, its plain version
    for CPU tensors."""
    V, H, W_, hid = maps_p.shape
    two_phase = crossview_route(V, H, W_, hid, maps_p.dtype) == "two_phase"
    if not maps_p.is_cuda:
        plain = crossview_two_phase_plain if two_phase else crossview_plain
        return plain(xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs)
    if two_phase:
        out = launch_crossview_two_phase(xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs)
        _lib.LAUNCHES["crossview_two_phase"] += 1
    else:
        out = launch_crossview(xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs)
        _lib.LAUNCHES["crossview"] += 1
    return out
