"""K2: unmasked, non-causal multi-head softmax attention.

Replaces mvdfusion_tpu/ops/attention.py::_fused_attention_fwd_impl (its four
Pallas kernels compute one function). The kernel is csrc/attention.cu: a
flash-style loop over key tiles in shared memory with an fp32 online softmax
and a masked ragged edge. Operands keep the reference layout: q (B, Nq, H, dh),
k/v (B, Nk, H, dh), given as (tensor, batch stride, row stride) views so the
transformer site can pass its packed qkv without a copy.
"""

from __future__ import annotations

import torch

from mvdfusion_tpu_torch.ops import _lib


def should_fuse_attention(q, k) -> bool:
    """The reference's gate (ops/attention.py::should_fuse): the large-token
    sites (CLIP's 257 tokens; the VAE mid-attention at batch 1)."""
    Nq, Nk, dh = q.shape[1], k.shape[1], q.shape[-1]
    if Nq < 256 or Nk < 128:
        return False
    if dh > 128 and q.shape[0] >= 2:
        return False
    return Nk <= 4096 and dh <= 512 and Nk * dh <= (1 << 20)


def attention_plain(q, k, v, scale: float):
    """fp32 softmax of (q k^T) * scale, probabilities cast to q's dtype."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _strides(t):
    """(batch stride, row stride) of a (B, N, H, dh) view whose last two dims
    are contiguous."""
    if t.stride(3) != 1 or t.stride(2) != t.shape[3]:
        raise ValueError("attention operands need contiguous (H, dh) rows")
    return t.stride(0), t.stride(1)


def launch_attention(q, k, v, scale: float, out=None):
    """Launch csrc/attention.cu (no counting). q/k/v may be strided views of
    one buffer; `out` (B, Nq, H, dh) contiguous is allocated if not given."""
    B, Nq, H, dh = q.shape
    Nk = k.shape[1]
    if out is None:
        out = torch.empty(B, Nq, H, dh, dtype=q.dtype, device=q.device)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention operands must share one dtype")
    (qb, qn), (kb, kn), (vb, vn) = _strides(q), _strides(k), _strides(v)
    _lib.call(
        "mvdf_attention", _lib.view_ptr(q), _lib.view_ptr(k), _lib.view_ptr(v), out, B, H, Nq, Nk, dh,
        qb, qn, kb, kn, vb, vn, out.stride(0), out.stride(1), float(scale), _lib.dtype_code(q.dtype),
    )
    return out


def fused_attention(q, k, v, scale: float):
    """(B, Nq, H, dh) attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    out = launch_attention(q, k, v, scale)
    _lib.LAUNCHES["attention"] += 1
    return out
