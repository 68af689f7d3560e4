"""K2: unmasked, non-causal multi-head softmax attention.

Replaces mvdfusion_tpu/ops/attention.py::_fused_attention_fwd_impl (its four
Pallas kernels compute one function in two forms). The kernel is
csrc/attention.cu. Operands keep the reference layout: q (B, Nq, H, dh),
k/v (B, Nk, H, dh), given as (tensor, batch stride, row stride) views so the
transformer site can pass its packed qkv without a copy.

The reference rounds in one of two forms, chosen from dh alone
(`attention_mode`); both take the logits in fp32:
- ``pv`` where its ones column is free (dh = 40, 64, 80: every dh < 128):
  e = exp((s - max) * scale) rounded to the operands' dtype, the row sum the
  fp32 sum of the rounded e, PV summed in fp32, times 1/sum, rounded once;
- ``probs`` at lane-aligned dh (128, 512): exp((s - max) * scale) over its
  fp32 sum, rounded, PV summed in fp32 and rounded once. The transformer
  sites' kernels (ops/block.py) round this way too.
The reference's A/B switches MVDF_ATTN_NORM and MVDF_ATTN_T pick Mosaic
layouts and do not carry over; its transposed orientation computes ``pv``.

Which kernel a call takes follows from its operands alone
(`attention_route`): csrc/attention_sm90.cu's wgmma tile for bf16 ``pv``
calls at dh = 64 with the scale dh^-0.5 (a power of two) over whole 128-row
tiles (MVDream's joined attn1),
csrc/attention.cu's mma.sync tile for the other bf16 calls at dh <= 128, and
its CUDA-core loop for the rest. All three round as `attention_plain` does.
"""

from __future__ import annotations

import math

import torch

from mvdfusion_tpu_torch.ops import _lib

MODE_PROBS, MODE_PV = 0, 1  # the kernel's `mode` argument
_SUBLANE = 8
SM90_DH = 64  # the head dim of csrc/attention_sm90.cu
SM90_TILE = 128  # its keys a stage; the route holds Nq to the same multiple


def ones_free(dh: int) -> bool:
    """The reference's test for its ``pv`` form (ops/attention.py:176-177,
    229-230): the ones column that carries the row sum fits the 128-lane
    tiles dh already pads to."""
    dh_p = -(-dh // _SUBLANE) * _SUBLANE
    dv = -(-(dh + 1) // _SUBLANE) * _SUBLANE
    return -(-dv // 128) == -(-dh_p // 128)


def attention_mode(dh: int) -> int:
    """K2's rounding form at head dim dh, as the reference picks it."""
    return MODE_PV if ones_free(dh) else MODE_PROBS


def should_fuse_attention(q, k) -> bool:
    """The reference's gate (ops/attention.py::should_fuse): the large-token
    sites (CLIP's 257 tokens; the VAE mid-attention at batch 1, the UNet's
    32^2 and 16^2 self-attention on the module path); closed under the
    kernel-off switch."""
    if _lib.switched_off():
        return False
    Nq, Nk, dh = q.shape[1], k.shape[1], q.shape[-1]
    if Nq < 256 or Nk < 128:
        return False
    if dh > 128 and q.shape[0] >= 2:
        return False
    return Nk <= 4096 and dh <= 512 and Nk * dh <= (1 << 20)


def attention_plain(q, k, v, scale: float, mode: int | None = None):
    """Plain version of K2, rounding where the reference's kernel rounds in
    `mode` (default: attention_mode(dh))."""
    dt = q.dtype
    mode = attention_mode(q.shape[-1]) if mode is None else mode
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    e = torch.exp((s - s.amax(-1, keepdim=True)) * scale)
    if mode == MODE_PV:
        e = e.to(dt).float()
        o = torch.einsum("bhqk,bkhd->bqhd", e, v.float())
        return (o * (1.0 / e.sum(-1)).transpose(1, 2)[..., None]).to(dt)
    p = (e / e.sum(-1, keepdim=True)).to(dt)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(dt)


def xla_attention(q, k, v, scale: float, causal: bool = False):
    """The reference's module path outside the kernel's gate (nn/layers.py::
    dot_attention, XLA): logits as a product in the operands' dtype, fp32
    softmax, probabilities cast to that dtype. `causal` masks key j > query
    i out of query i's softmax."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Nq, Nk = q.shape[1], k.shape[1]
        later = torch.ones(Nq, Nk, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(later, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _strides(t):
    """(batch stride, row stride) of a (B, N, H, dh) view whose last two dims
    are contiguous."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        raise ValueError("attention operands need contiguous (H, dh) rows")
    return t.stride(0), t.stride(1)


def _tma_rows(t) -> bool:
    """Whether TMA can read (B, N, H, dh) view `t` by rows: (H, dh)
    contiguous, row and batch strides positive multiples of 16 bytes, the
    base pointer 16-byte aligned."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        return False
    return all(s > 0 and s % 8 == 0 for s in (t.stride(0), t.stride(1))) and t.data_ptr() % 16 == 0


def pow2_scale(scale: float) -> bool:
    """Whether `scale` is a positive power of two: q * scale is then exact in
    bf16, and csrc/attention_sm90.cu scales Q once in shared memory."""
    return scale > 0 and math.frexp(scale)[0] == 0.5


def attention_route(q, k, v, scale: float, mode: int | None = None) -> str:
    """The kernel launch_attention takes for these operands: "sm90"
    (csrc/attention_sm90.cu) for bf16 on the card in the pv form at dh 64
    with a power-of-two scale (dh^-0.5 = 1/8), Nq and Nk multiples of
    SM90_TILE with Nk >= 2 SM90_TILE, rows and base pointers on TMA's
    16-byte rule; "mma" (attention.cu's tensor-core tile) for every other
    bf16 call at dh <= 128; "fp32" (its CUDA-core loop) for fp32 operands
    and larger heads. Decided from dtype, dh, mode, scale, the query and key
    counts and alignment alone."""
    dh = q.shape[-1]
    if q.dtype != torch.bfloat16 or dh > 128:
        return "fp32"
    if dh != SM90_DH or (attention_mode(dh) if mode is None else mode) != MODE_PV or not pow2_scale(scale):
        return "mma"
    Nq, Nk = q.shape[1], k.shape[1]
    whole = Nq % SM90_TILE == 0 and Nk % SM90_TILE == 0 and Nk >= 2 * SM90_TILE
    on_card = all(t.device.type == "cuda" and t.dtype == q.dtype for t in (q, k, v))
    return "sm90" if whole and on_card and all(_tma_rows(t) for t in (q, k, v)) else "mma"


def launch_attention(q, k, v, scale: float, mode: int | None = None, out=None, route: str | None = None):
    """Launch K2 (no counting) on `route`: attention_route's choice (worked
    out here if not given), or "mma" to take attention.cu's tile where the
    route is "sm90" (chip_smoke.py times both). q/k/v may be strided views
    of one buffer; `out` (B, Nq, H, dh) contiguous is allocated if not
    given. `mode` (default attention_mode(dh)) sets the tensor-core tiles'
    rounding; the fp32 loop keeps its probabilities in fp32. The sm90 tile
    is two launches: the row max, then the softmax and PV."""
    _lib.no_graph("launch_attention", q, k, v)
    B, Nq, H, dh = q.shape
    Nk = k.shape[1]
    mode = attention_mode(dh) if mode is None else mode
    route = route or attention_route(q, k, v, scale, mode)
    if route == "sm90" and (q.dtype != torch.bfloat16 or dh != SM90_DH or mode != MODE_PV):
        raise ValueError("csrc/attention_sm90.cu takes bf16 operands at dh 64 in the pv form")
    if out is None:
        out = torch.empty(B, Nq, H, dh, dtype=q.dtype, device=q.device)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention operands must share one dtype")
    (qb, qn), (kb, kn), (vb, vn) = _strides(q), _strides(k), _strides(v)
    if route == "sm90":  # the entry point refuses counts, strides, pointers and scales off attention_route's rule
        rowmax = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device)  # the max pass's scratch
        _lib.call("mvdf_attention_sm90", _lib.view_ptr(q), _lib.view_ptr(k), _lib.view_ptr(v), out, rowmax, B, H, Nq,
                  Nk, qb, qn, kb, kn, vb, vn, out.stride(0), out.stride(1), float(scale))
        return out
    if q.dtype == torch.bfloat16 and dh <= 128:
        # the tensor-core tile (else the fp32 loop): 16-byte copies of K and
        # V rows, 4-byte reads of q and writes of out
        rows16 = all(s % 8 == 0 for s in (dh, kb, kn, vb, vn)) and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
        if not (rows16 and qb % 2 == 0 and qn % 2 == 0 and q.data_ptr() % 4 == 0):
            raise ValueError("the bf16 attention tile needs dh % 8 == 0 and 16-byte aligned K/V rows")
    _lib.call(
        "mvdf_attention", _lib.view_ptr(q), _lib.view_ptr(k), _lib.view_ptr(v), out, B, H, Nq, Nk, dh,
        qb, qn, kb, kn, vb, vn, out.stride(0), out.stride(1), float(scale), int(mode), _lib.dtype_code(q.dtype),
    )
    return out


def fused_attention(q, k, v, scale: float):
    """(B, Nq, H, dh) attention: the CUDA kernel on attention_route's route
    where _lib.launches (its gradient the plain version's), else the plain
    version. Counts its launches: two under "attention_sm90" (the row max,
    then the main pass) or one under "attention"."""
    if not _lib.launches(q):
        return attention_plain(q, k, v, scale)
    route = attention_route(q, k, v, scale)
    out = _lib.with_plain_backward(lambda q, k, v: launch_attention(q, k, v, scale, route=route),
                                   lambda q, k, v: attention_plain(q, k, v, scale), q, k, v)
    if route == "sm90":
        _lib.LAUNCHES["attention_sm90"] += 2
    else:
        _lib.LAUNCHES["attention"] += 1
    return out
