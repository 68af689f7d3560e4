"""K4: cross-view aggregation, the GridAttn hot path.

Replaces mvdfusion_tpu/ops/crossview.py::_crossview_fwd_impl, single-kernel
form (_kernel with _geo_aug_t, _erf/_gelu, _dit_pool). For each query point
and each of V views: a bilinear gather from the view's pre-projected map at
the negated NDC coordinates, + the geometric embedding (ray direction,
Plucker moment, depth and their sin/cos at omega0 * 2^k, through `kall`),
+ mask * kmask + b_acc, exact GELU; then the adaLN-Zero DiT layers across V
(modulation precomputed once per step), a softmax pool over V and
final_layer.

On the card (see csrc/crossview.cu for the design): the gather kernel writes
fp32 (N, V, hid) tokens; each DiT layer is LayerNorm -> GEMM (qkv, fp32) ->
per-point view attention -> GEMM with a gated in-place residual -> LayerNorm
-> GEMM + GELU -> GEMM with a gated residual; then the pool kernel and the
final GEMM. The residual stream stays fp32 as in the reference kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from mvdfusion_tpu_torch.geometry.gridsample import grid_sample
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


class GeoWeights(NamedTuple):
    """The geometric token parts' projection, rows matching geo_aug's
    [raw 7 | sin freq-major | cos freq-major] features."""

    kall: torch.Tensor  # (7 * (1 + 2 * nh), hid)
    kmask: torch.Tensor  # (hid,)


def should_fuse_crossview(V: int, H: int, W: int, hid: int) -> bool:
    """The reference's gate (ops/crossview.py::should_fuse_crossview; the
    top-k view window it also excludes is not ported)."""
    return V <= 16 and H * W <= 8192 and hid <= 512


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


def crossview_plain(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                    heads: int, freqs: tuple):
    """Plain PyTorch version. xy (V, N, 2) negated NDC, pts (N, 3), centers
    (V, 3), mask (V,), b_acc (N, hid), maps_p (V, H, W, hid) -> (N, out_dim)
    in maps_p's dtype. Products take dt-rounded operands with fp32 results;
    the residual stream, the geometric features and the gather are fp32."""
    V, N, _ = xy.shape
    hid = maps_p.shape[-1]
    dt = maps_p.dtype
    dh = hid // heads

    def mm(a, k, b=None):  # k in (out, in) layout
        y = a.to(dt).float() @ k.to(dt).float().t()
        return y if b is None else y + b.float()

    gathered = grid_sample(maps_p.float(), xy.float())  # (V, N, hid)
    toks = gathered + geo_aug(pts, centers, freqs) @ kg.kall.float() + mask.float()[:, None, None] * kg.kmask.float()
    x = F.gelu(toks.transpose(0, 1) + b_acc.float()[:, None, :])  # (N, V, hid)
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


def launch_crossview(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                     heads: int, freqs: tuple):
    """K4 on the card: gather, DiT layers, pool and output GEMM (no counting)."""
    V, N, _ = xy.shape
    _, H, W_, hid = maps_p.shape
    dt = maps_p.dtype
    dev = maps_p.device
    code = _lib.dtype_code(dt)
    c = lambda t: t.to(dt).contiguous()
    f = lambda t: t.float().contiguous()
    x = torch.empty(N * V, hid, dtype=torch.float32, device=dev)
    freq_t = torch.tensor(freqs, dtype=torch.float32, device=dev)
    _lib.call(
        "mvdf_cv_gather", f(xy), f(pts), f(centers), f(mask),
        c(b_acc), c(maps_p), c(kg.kall), f(kg.kmask),
        freq_t, len(freqs), x, V, N, H, W_, hid, code,
    )
    att = torch.empty(N * V, hid, dtype=dt, device=dev)
    for l in range(len(w.qkv_w)):
        m = f(w.mods[l])
        h = layernorm(x, 1 + m[1], m[0], _DIT_LN_EPS, out_dtype=dt)
        qkv = gemm(h, c(w.qkv_w[l]), w.qkv_b[l], out_dtype=torch.float32)
        _lib.call("mvdf_cv_attention", qkv, att, N, V, heads, hid // heads,
                  float((hid // heads) ** -0.5), code)
        gemm(att, c(w.proj_w[l]), w.proj_b[l], gate=m[2], res1=x, out=x)
        h = layernorm(x, 1 + m[4], m[3], _DIT_LN_EPS, out_dtype=dt)
        h = gemm(h, c(w.fc1_w[l]), w.fc1_b[l], act=ACT_GELU)
        gemm(h, c(w.fc2_w[l]), w.fc2_b[l], gate=m[5], res1=x, out=x)
    pooled = torch.empty(N, hid, dtype=dt, device=dev)
    _lib.call("mvdf_cv_pool", x, c(w.wl_w.reshape(-1)), f(w.wl_b.reshape(-1)),
              pooled, N, V, hid, code)
    return gemm(pooled, c(w.fin_w), w.fin_b)


def crossview_aggregate(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                        heads: int, freqs: tuple):
    """Pooled, projected frustum features (N, out_dim): the CUDA kernels for
    CUDA tensors, the plain version for CPU tensors."""
    if not maps_p.is_cuda:
        return crossview_plain(xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs)
    out = launch_crossview(xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs)
    _lib.LAUNCHES["crossview"] += 1
    return out
