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
the fp32 residual stream, (N, V, hid) point-major, in either form's
numerics (`gather_route`: bf16 takes the tensor-core gather); each DiT layer
is then the modulated LayerNorm -> qkv GEMM with the attention across views
in its tiles (`attention_route`: bf16 takes csrc/gemm_sm90.cu's qkv tile,
which never writes qkv to device memory) -> GEMM with a gated in-place
residual -> LayerNorm -> GEMM + GELU -> GEMM with a gated residual; then
the pool kernel and the final GEMM. The residual stream stays fp32 as in the
reference kernels. The GEMMs are ops/block.py's site GEMM. The kernels read
the weights prepared once (`prepare_crossview_weights`: matrices in the
maps' dtype, each head's q, k and v rows side by side, vectors fp32, the
harmonic frequencies on the device); nn/viewattn.py keeps them on its module
(`prepared_crossview_weights`) until a parameter changes. The plain versions
read the unpacked layout.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from mvdfusion_tpu_torch.geometry.gridsample import bilinear_gather
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.block import ACT_GELU, _weight_desc, gemm

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
    qkv_heads: int = 0  # > 0: qkv_w's rows and qkv_b packed per head for this many heads (pack_qkv_heads)


class PreparedAggregator(AggregatorWeights):
    """AggregatorWeights as the card's kernels read them
    (prepare_crossview_weights): matrices in the maps' dtype and contiguous,
    qkv_w and qkv_b packed per head, biases fp32."""

    __slots__ = ()


class GeoWeights(NamedTuple):
    """The geometric token parts' projection, rows matching geo_aug's
    [raw 7 | sin freq-major | cos freq-major] features."""

    kall: torch.Tensor  # (7 * (1 + 2 * nh), hid)
    kmask: torch.Tensor  # (hid,)
    freqs: torch.Tensor | None = None  # (nh,) fp32 on kall's device, once prepared


def should_fuse_crossview(V: int, H: int, W: int, hid: int) -> bool:
    """The reference's gate (ops/crossview.py::should_fuse_crossview; its
    caller, nn/viewattn.py, leaves the top-k view window on the general
    path); closed under the kernel-off switch."""
    if _lib.switched_off():
        return False
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


def pack_qkv_heads(w, b, heads: int):
    """Reorder qkv rows [Wq; Wk; Wv] (and the bias alike) so each head's q, k
    and v rows sit side by side: head h at rows 3 dh h .. 3 dh (h + 1), the
    qkv tile's width (csrc/gemm_sm90.cu)."""
    K = w.shape[1]
    dh = w.shape[0] // (3 * heads)
    wp = w.reshape(3, heads, dh, K).transpose(0, 1).reshape(3 * heads * dh, K)
    return wp.contiguous(), b.reshape(3, heads, dh).transpose(0, 1).reshape(-1).contiguous()


def unpack_qkv_heads(wp, bp, heads: int):
    """The inverse of pack_qkv_heads: rows [Wq; Wk; Wv] again."""
    K = wp.shape[1]
    dh = wp.shape[0] // (3 * heads)
    return (wp.reshape(heads, 3, dh, K).transpose(0, 1).reshape(3 * heads * dh, K),
            bp.reshape(heads, 3, dh).transpose(0, 1).reshape(-1))


def unprepared_crossview_weights(w: AggregatorWeights) -> AggregatorWeights:
    """The plain versions' view of weights: qkv rows unpacked (exactly: a
    reordering), everything else as it is."""
    if not w.qkv_heads:
        return w
    qkv = [unpack_qkv_heads(a, b, w.qkv_heads) for a, b in zip(w.qkv_w, w.qkv_b)]
    return AggregatorWeights(*w)._replace(qkv_w=[a for a, _ in qkv], qkv_b=[b for _, b in qkv], qkv_heads=0)


def _attention_plain(qkv, N: int, V: int, heads: int):
    """qkv (N * V, 3 hid) fp32 rows [q | k | v] -> (N * V, hid) fp32: softmax
    attention across each point's V rows, per head."""
    hid = qkv.shape[-1] // 3
    dh = hid // heads
    q, k, v = (a.reshape(N, V, heads, dh) for a in qkv.chunk(3, dim=-1))
    p = torch.softmax(torch.einsum("nvhd,nwhd->nhvw", q, k) * dh**-0.5, dim=-1)
    return torch.einsum("nhvw,nwhd->nvhd", p, v).reshape(N * V, hid)


def _mm(a, k, b, dt):
    """a @ k^T (k in (out, in) layout) of dt-rounded operands in fp32, + the
    fp32 bias (or none)."""
    y = a.to(dt).float() @ k.to(dt).float().t()
    return y if b is None else y + b.float()


def view_attention_plain(h, qkv_w, qkv_b, V: int, heads: int):
    """Plain version of `view_attention` on weights packed per head: the qkv
    product in fp32 (operands in h's dtype) + bias, the attention across
    views in fp32, rounded once to h's dtype."""
    w, b = unpack_qkv_heads(qkv_w, qkv_b, heads)
    return _attention_plain(_mm(h, w, b, h.dtype), h.shape[0] // V, V, heads).to(h.dtype)


def _dit_pool_plain(x, w: AggregatorWeights, heads: int, dt):
    """x (N, V, hid) fp32 GELU'd tokens -> (N, out_dim) in dt: the DiT
    layers across V, the softmax pool and final_layer (the reference's
    _dit_pool, shared by both forms)."""
    N, V, hid = x.shape
    w = unprepared_crossview_weights(w)
    mm = lambda a, k, b=None: _mm(a, k, b, dt)
    xf = x.reshape(N * V, hid)
    for l in range(len(w.qkv_w)):
        m = w.mods[l].float()
        h = _layernorm_plain(xf) * (1 + m[1]) + m[0]
        att = _attention_plain(mm(h, w.qkv_w[l], w.qkv_b[l]), N, V, heads)
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


def gather_stream_plain(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, freqs: tuple, two_phase: bool):
    """Plain version of the gather kernel's output: the fp32 residual stream
    (N * V, hid), point-major, each element GELU(t + b_acc) (single form) or
    GELU(float(dt(t)) + b_acc) (two-phase form: the phase-1 token rounded to
    the maps' dtype first, then b_acc and the GELU in the same pass), t the
    token sum of gather_tokens_plain."""
    dt = maps_p.dtype
    N, hid = b_acc.shape
    t = gather_tokens_plain(xy, pts, centers, mask, maps_p, kg, freqs).transpose(0, 1)  # (N, V, hid)
    if two_phase:
        t = t.to(dt).float()
    return F.gelu(t + b_acc.float()[:, None, :]).reshape(-1, hid)


def prepare_crossview_weights(kg: GeoWeights, w: AggregatorWeights, dtype, heads: int, freqs: tuple | None = None):
    """(kg, w) as the card's kernels read them for maps of `dtype`: matrices
    cast to dtype and contiguous (aliases where they already are), qkv_w and
    qkv_b packed per head, vectors fp32, `freqs` as an fp32 tensor on kall's
    device (made once here, so a call copies nothing from the host); w's
    per-step mods as they come. Prepared weights pass unchanged."""
    mat = lambda t: t.detach().to(dtype).contiguous()
    vec = lambda t: t.detach().float().contiguous()
    if not isinstance(w, PreparedAggregator):
        qkv = [pack_qkv_heads(mat(a), vec(b), heads) for a, b in zip(w.qkv_w, w.qkv_b)]
        w = PreparedAggregator(
            qkv_w=[a for a, _ in qkv], qkv_b=[b for _, b in qkv],
            proj_w=[mat(t) for t in w.proj_w], proj_b=[vec(t) for t in w.proj_b],
            fc1_w=[mat(t) for t in w.fc1_w], fc1_b=[vec(t) for t in w.fc1_b],
            fc2_w=[mat(t) for t in w.fc2_w], fc2_b=[vec(t) for t in w.fc2_b],
            mods=w.mods, wl_w=mat(w.wl_w), wl_b=vec(w.wl_b), fin_w=mat(w.fin_w), fin_b=vec(w.fin_b),
            qkv_heads=heads,
        )
    elif w.fin_w.dtype != dtype or w.qkv_heads != heads:
        raise ValueError(f"aggregator weights prepared for {w.fin_w.dtype} and {w.qkv_heads} heads, "
                         f"used with maps in {dtype} and {heads} heads")
    f_t = kg.freqs
    if f_t is None and freqs is not None:
        f_t = torch.tensor(freqs, dtype=torch.float32).to(kg.kall.device)
    return GeoWeights(kall=mat(kg.kall), kmask=vec(kg.kmask), freqs=f_t), w


def prepared_crossview_weights(owner, params, build, dtype, heads: int, freqs: tuple):
    """prepare_crossview_weights(*build(), dtype, heads, freqs), kept on
    `owner` (GridAttn's module) until the data pointer, version or dtype of
    one of `params` (every parameter that `build` reads) changes, or dtype
    does."""
    return _lib.cached(owner, "_mvdf_crossview_weights", params, dtype,
                       lambda: prepare_crossview_weights(*build(), dtype, heads, freqs))


# ------------------------------------------------------------ kernel launchers
QKV_TILE_ROWS = 128  # the qkv tile's A box (csrc/gemm_sm90.cu)
QKV_TILE_N = 96  # one head's packed q, k and v rows at dh = 32


def gather_route(dtype, hid: int, nh: int) -> str:
    """The gather kernel for these maps, chosen explicitly: "mma" (the
    tensor-core gather) for bf16 maps with hid a multiple of 64 up to 512
    and at most 7 harmonics (G <= 112), else "simt" (the CUDA-core loop).
    Each counts under cv_gather_<route>."""
    return "mma" if dtype == torch.bfloat16 and hid % 64 == 0 and hid <= 512 and nh <= 7 else "simt"


def attention_route(dtype, V: int, hid: int, heads: int) -> str:
    """Where the view attention runs, chosen explicitly: "fused" (inside the
    qkv GEMM's tiles, csrc/gemm_sm90.cu: bf16, dh = 32, hid <= 256, V <= 16)
    or "standalone" (the qkv GEMM writes fp32 qkv, then crossview.cu's
    attention kernel). Counted under cv_qkv_attention and cv_attention."""
    fits = dtype == torch.bfloat16 and hid == 32 * heads and hid <= 256 and V <= 16
    return "fused" if fits else "standalone"


def qkv_tile_points(V: int) -> int:
    """Whole points a qkv tile holds: floor(128 / V)."""
    return QKV_TILE_ROWS // V


def qkv_tile_plan(N: int, V: int):
    """The qkv tile's rows (first row, rows) over the N * V token rows,
    point-major, as the kernel walks them: qkv_tile_points(V) points a tile,
    the last tile ragged."""
    step = qkv_tile_points(V) * V
    return [(r, min(step, N * V - r)) for r in range(0, N * V, step)]


def _freq_tensor(kg: GeoWeights, freqs: tuple, device):
    """The harmonic frequencies on the device: prepared weights carry them."""
    if kg.freqs is not None:
        if kg.freqs.numel() != len(freqs):
            raise ValueError(f"prepared for {kg.freqs.numel()} harmonics, called with {len(freqs)}")
        return kg.freqs
    return torch.tensor(freqs, dtype=torch.float32).to(device)


_GATHER_MODES = {"single": 0, "tokens": 1, "two_phase": 2}


def launch_gather(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, freqs: tuple, mode: str):
    """The gather kernel: "single" and "two_phase" write the fp32 residual
    stream (N * V, hid) (gather_stream_plain's), "tokens" the two-phase
    form's phase-1 tokens (N, V, hid) in maps_p's dtype (the transpose of
    gather_tokens_plain's, rounded). Counts under cv_gather_<route>."""
    _lib.no_graph("launch_gather", xy, pts, centers, mask, b_acc, maps_p, kg.kall, kg.kmask)
    V, N, _ = xy.shape
    _, H, W_, hid = maps_p.shape
    dt = maps_p.dtype
    route = gather_route(dt, hid, len(freqs))
    f = lambda t: t.float().contiguous()
    shape, odt = ((N, V, hid), dt) if mode == "tokens" else ((N * V, hid), torch.float32)
    out = torch.empty(shape, dtype=odt, device=maps_p.device)
    bacc = None if mode == "tokens" else b_acc.to(dt).contiguous()
    _lib.call(
        "mvdf_cv_gather", f(xy), f(pts), f(centers), f(mask), bacc, maps_p.contiguous(),
        kg.kall.to(dt).contiguous(), f(kg.kmask), _freq_tensor(kg, freqs, maps_p.device), len(freqs), out,
        V, N, H, W_, hid, _lib.dtype_code(dt), _GATHER_MODES[mode], int(route == "mma"),
    )
    _lib.LAUNCHES[f"cv_gather_{route}"] += 1
    return out


def launch_gather_tokens(xy, pts, centers, mask, maps_p, kg: GeoWeights, freqs: tuple):
    """The two-phase form's phase 1 on the card: (N, V, hid) tokens in
    maps_p's dtype, point-major (the transpose of gather_tokens_plain)."""
    return launch_gather(xy, pts, centers, mask, None, maps_p, kg, freqs, "tokens")


def dit_layernorm(x, scale, shift, dt):
    """csrc/crossview.cu's DiT LayerNorm: LN(x) * (1 + scale) + shift over
    the fp32 stream x (M, hid), eps 1e-6, out in dt."""
    _lib.no_graph("dit_layernorm", x, scale, shift)
    M, C = x.shape
    y = torch.empty(M, C, dtype=dt, device=x.device)
    _lib.call("mvdf_cv_layernorm", x, scale.float().contiguous(), shift.float().contiguous(), y, M, C,
              float(_DIT_LN_EPS), _lib.dtype_code(dt))
    return y


def view_attention(h, qkv_w, qkv_b, V: int, heads: int, route: str | None = None):
    """att (N * V, hid) in h's dtype: the attention across each point's V
    rows of qkv = h @ qkv_w^T + qkv_b, with qkv_w and qkv_b packed per head
    (pack_qkv_heads). `route`: attention_route's choice, or "standalone" to
    take it for a bf16 comparison. The fused route never writes qkv to
    device memory."""
    _lib.no_graph("view_attention", h, qkv_w, qkv_b)
    M, K = h.shape
    hid = qkv_w.shape[0] // 3
    dh = hid // heads
    fits = attention_route(h.dtype, V, hid, heads)
    route = route or fits
    if route not in ("fused", "standalone") or (route == "fused" and fits != "fused"):
        raise ValueError(f"view attention route {route!r} does not take {h.dtype} at V={V}, hid={hid}, {heads} heads")
    out = torch.empty(M, hid, dtype=h.dtype, device=h.device)
    if route == "fused":
        h = h.contiguous()
        _lib.call("mvdf_qkv_attention_sm90", h, _weight_desc(qkv_w, QKV_TILE_N), qkv_b.float().contiguous(), out,
                  M, K, V, qkv_tile_points(V), heads, float(dh**-0.5))
        _lib.LAUNCHES["cv_qkv_attention"] += 1
    else:
        qkv = gemm(h, qkv_w, qkv_b, out_dtype=torch.float32)
        _lib.call("mvdf_cv_attention", qkv, out, M // V, V, heads, dh, float(dh**-0.5), _lib.dtype_code(h.dtype))
        _lib.LAUNCHES["cv_attention"] += 1
    return out


def _launch_dit_pool(x, N: int, V: int, w: PreparedAggregator, heads: int, dt):
    """x (N * V, hid) fp32 GELU'd tokens, updated in place -> (N, out_dim)."""
    hid = x.shape[-1]
    for l in range(len(w.qkv_w)):
        m = w.mods[l].float()
        att = view_attention(dit_layernorm(x, m[1], m[0], dt), w.qkv_w[l], w.qkv_b[l], V, heads)
        gemm(att, w.proj_w[l], w.proj_b[l], gate=m[2], res1=x, out=x)
        h = gemm(dit_layernorm(x, m[4], m[3], dt), w.fc1_w[l], w.fc1_b[l], act=ACT_GELU)
        gemm(h, w.fc2_w[l], w.fc2_b[l], gate=m[5], res1=x, out=x)
    return gemm(launch_pool(x, N, V, w.wl_w, w.wl_b, dt), w.fin_w, w.fin_b)


def launch_pool(x, N: int, V: int, wl_w, wl_b, dt):
    """The pool kernel: (N, hid) in dt, sum over each point's V rows of x
    weighted by softmax_v(dt(x) . wl_w + wl_b)."""
    _lib.no_graph("launch_pool", x, wl_w, wl_b)
    hid = x.shape[-1]
    pooled = torch.empty(N, hid, dtype=dt, device=x.device)
    _lib.call("mvdf_cv_pool", x, wl_w.reshape(-1), wl_b.reshape(-1), pooled, N, V, hid, _lib.dtype_code(dt))
    return pooled


def launch_crossview(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                     heads: int, freqs: tuple):
    """K4's single form on the card: gather, DiT layers, pool and output
    GEMM (no counting); kg and w as the parameters are or prepared."""
    kg, w = prepare_crossview_weights(kg, w, maps_p.dtype, heads, freqs)
    x = launch_gather(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, "single")
    return _launch_dit_pool(x, xy.shape[1], xy.shape[0], w, heads, maps_p.dtype)


def launch_crossview_two_phase(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                               heads: int, freqs: tuple):
    """K4's two-phase form on the card: the gather rounds each token to
    maps_p's dtype, adds b_acc and applies the GELU into the fp32 stream in
    one pass, then the same DiT, pool and output GEMM as the single form (no
    counting); kg and w as the parameters are or prepared."""
    kg, w = prepare_crossview_weights(kg, w, maps_p.dtype, heads, freqs)
    x = launch_gather(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, "two_phase")
    return _launch_dit_pool(x, xy.shape[1], xy.shape[0], w, heads, maps_p.dtype)


def _flat_weights(kg: GeoWeights, w: AggregatorWeights) -> list:
    """kg's and w's tensors in one list (the lists of w's per-layer weights
    spread out), the inverse of _unflat_weights."""
    out = [kg.kall, kg.kmask]
    for f in AggregatorWeights._fields[:-1]:
        v = getattr(w, f)
        out += list(v) if isinstance(v, (list, tuple)) else [v]
    return out


def _unflat_weights(t, L: int, qkv_heads: int):
    """(GeoWeights, AggregatorWeights) from _flat_weights' list, L layers."""
    t = list(t)
    kg, t = GeoWeights(t[0], t[1]), t[2:]
    per_layer = {f: [t.pop(0) for _ in range(L)] for f in AggregatorWeights._fields[:8]}
    mods, wl_w, wl_b, fin_w, fin_b = t
    return kg, AggregatorWeights(**per_layer, mods=mods, wl_w=wl_w, wl_b=wl_b, fin_w=fin_w, fin_b=fin_b,
                                 qkv_heads=qkv_heads)


def crossview_aggregate(xy, pts, centers, mask, b_acc, maps_p, kg: GeoWeights, w: AggregatorWeights,
                        heads: int, freqs: tuple, prepared: tuple | None = None):
    """Pooled, projected frustum features (N, out_dim) by the reference's
    route: the CUDA kernels of that form where _lib.launches, else its plain
    version. The kernels read `prepared` (kg, w) where given, else kg and w;
    the gradient is the plain version's on kg and w (as the parameters are,
    the gradient's path to them)."""
    V, H, W_, hid = maps_p.shape
    two_phase = crossview_route(V, H, W_, hid, maps_p.dtype) == "two_phase"
    plain = crossview_two_phase_plain if two_phase else crossview_plain
    if not _lib.launches(maps_p):
        return plain(xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs)
    launch = launch_crossview_two_phase if two_phase else launch_crossview
    pkg, pw = (kg, w) if prepared is None else prepared
    L = len(w.qkv_w)
    out = _lib.with_plain_backward(
        lambda *t: launch(*t[:6], pkg, pw, heads, freqs),
        lambda *t: plain(*t[:6], *_unflat_weights(t[6:], L, w.qkv_heads), heads, freqs),
        xy, pts, centers, mask, b_acc, maps_p, *_flat_weights(kg, w))
    _lib.LAUNCHES["crossview_two_phase" if two_phase else "crossview"] += 1
    return out
