"""K8: the fused GroupNorm affine + SiLU -> 3x3 conv (stride 1, SAME) of the
VAE ResBlocks, with its statistics pass (torch counterpart of
mvdfusion_tpu/ops/conv3x3.py).

Off unless MVDF_CONV3X3=1, as in the reference (`should_fuse_conv3x3`, read
when called). Under it nn/vae.py::VAEResnetBlock computes
    a1, b1 = gn_fold_affine(x, norm1)        one fp32 statistics pass
    h = conv(silu(x*a1 + b1)) + bias          gn_silu_conv3x3
    a2, b2 = gn_fold_affine(h, norm2)
    out = conv(silu(h*a2 + b2)) + bias + res  res = x or nin_shortcut(x)
- gn_fold_affine replaces the reference's gn_fold_affine (:62), whose stats
  pass is _gn_stats_kernel: on the card csrc/groupnorm.cu's K7 stats pass,
  one launch whose folding CTAs use the reference's UNCLAMPED variance,
  rsqrt(E[x^2] - mu^2 + eps) (conv3x3.py:89; its tiled GroupNorm clamps).
- gn_silu_conv3x3 replaces _fwd_impl -> _conv_kernel (:95, :230): on the
  card csrc/conv3x3.cu, an implicit GEMM whose prologue applies the folded
  affine and SiLU once per staged element (bf16: mma.sync tiles of 128
  pixels x 128 output channels fed by a cp.async ring, fp32 sums; fp32: full
  fp32 on the CUDA cores), and whose epilogue adds bias + row[b] (+ res) in
  fp32 and rounds once. Activations are NHWC; the weight is the torch conv's
  (Cout, Cin, 3, 3) parameter, packed once per parameter into the kernel's
  tap-major (9*Cin, Cout) layout in the compute dtype.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops.groupnorm import channel_sums_plain, fold_affine, launch_fold

# the reference's tap order: [dy, dx] for dy in (-1, 0, 1) for dx in (-1, 0, 1)
_TAPS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))


def should_fuse_conv3x3(shape, groups: int = 32) -> bool:
    """The reference's gate (ops/conv3x3.py::should_fuse_conv3x3): off unless
    MVDF_CONV3X3=1 (read when called); then C a multiple of 128 and of
    `groups`, W a multiple of 8, H*W >= 4096 and H >= 2; closed under the
    kernel-off switch."""
    if not os.environ.get("MVDF_CONV3X3") or _lib.switched_off():
        return False
    B, H, W, C = shape
    if C % 128 or C % groups or W % 8:
        return False
    return H * W >= 4096 and H >= 2


# ----------------------------------------------------------------- statistics
def gn_fold_affine_plain(x_flat, scale, bias, groups: int, eps: float):
    """Plain version: (B, N, C) -> (a, b), each (B, C) fp32, with
    normalize(x)*scale + bias == x*a + b; the variance unclamped."""
    s1, s2 = channel_sums_plain(x_flat)
    return fold_affine(s1, s2, scale, bias, groups, x_flat.shape[1], eps, clamp=False)


def launch_gn_fold_affine(x_flat, scale, bias, groups: int, eps: float):
    """The K7 stats pass with its fold, unclamped, on a CUDA (B, N, C) tensor
    (no counting)."""
    return launch_fold(x_flat, scale, bias, groups, eps, clamp=False)


def gn_fold_affine(x_flat, scale, bias, groups: int, eps: float):
    """The folded GroupNorm affine of (B, N, C) x_flat: the stats kernel where
    _lib.launches, else the plain version. It has no gradient (nor has the
    reference's): on the kernel route an input that needs one raises."""
    if not _lib.launches(x_flat):
        return gn_fold_affine_plain(x_flat, scale, bias, groups, eps)
    out = launch_gn_fold_affine(x_flat, scale, bias, groups, eps)
    _lib.LAUNCHES["gn_fold_affine"] += 1
    return out


# ----------------------------------------------------------------------- conv
def conv3x3_plain(x, a, b, w, bias, row, res=None, act: str = "silu"):
    """Plain version of the reference's _xla_twin: x (B, H, W, Cin), a, b (B,
    Cin), w (Cout, Cin, 3, 3), bias (Cout,), row (B, Cout), res None or (B, H,
    W, Cout). s = silu(x*a + b) in fp32, rounded to x's dtype; a SAME 3x3 conv
    of s and w (rounded to x's dtype) with the products summed in fp32 (run
    as an fp32 conv of the rounded operands, whose products are exact);
    + bias + row[b] (+ res) in fp32, rounded once."""
    dt = x.dtype
    s = x.float() * a[:, None, None, :].float() + b[:, None, None, :].float()
    if act == "silu":
        s = s * torch.sigmoid(s)
    s = s.to(dt).float().permute(0, 3, 1, 2)
    y = F.conv2d(s, w.to(dt).float(), padding=1).permute(0, 2, 3, 1)
    y = y + bias.float() + row[:, None, None, :].float()
    if res is not None:
        y = y + res.float()
    return y.to(dt)


def pack_weight(w, dtype):
    """(Cout, Cin, 3, 3) -> the kernel's (9*Cin, Cout) in `dtype`: row
    tap*Cin + ci holds w[:, ci, dy+1, dx+1] for tap (dy, dx) of _TAPS."""
    Cout, Cin = w.shape[:2]
    return w.detach().to(dtype).permute(2, 3, 1, 0).reshape(9 * Cin, Cout).contiguous()


def packed_weight(w, dtype):
    """pack_weight(w, dtype), made once per parameter and kept on it until the
    parameter's data, version or dtype changes."""
    key = (w.data_ptr(), w._version, w.dtype, dtype)
    hit = getattr(w, "_mvdf_conv3x3_packed", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weight(w, dtype))
        w._mvdf_conv3x3_packed = hit
    return hit[1]


def launch_conv3x3(x, a, b, w9, bias, row, res=None, act: str = "silu"):
    """Launch csrc/conv3x3.cu on CUDA tensors, w9 the packed (9*Cin, Cout)
    weight in x's dtype (no counting)."""
    _lib.no_graph("launch_conv3x3", x, a, b, w9, bias, row, res)
    B, H, W, Cin = x.shape
    Cout = w9.shape[1]
    if tuple(w9.shape) != (9 * Cin, Cout) or w9.dtype != x.dtype:
        raise ValueError(f"packed weight {tuple(w9.shape)} {w9.dtype} for Cin={Cin}, {x.dtype}")
    if Cout % 8:
        raise ValueError(f"Cout={Cout}: the kernel reads the weight in 16-byte rows (Cout % 8 == 0)")
    if x.dtype == torch.bfloat16 and Cin % 8:
        raise ValueError(f"Cin={Cin}: the bf16 kernel copies x in 16-byte rows (Cin % 8 == 0)")
    if res is not None and tuple(res.shape) != (B, H, W, Cout):
        raise ValueError(f"residual {tuple(res.shape)} for output {(B, H, W, Cout)}")
    x, w9 = x.contiguous(), w9.contiguous()
    y = torch.empty(B, H, W, Cout, dtype=x.dtype, device=x.device)
    f32 = lambda t: t.float().contiguous()
    a, b = f32(a), f32(b)
    if any(t.data_ptr() % 16 for t in (x, w9, a, b)):
        raise ValueError("conv3x3 operands must be 16-byte aligned")
    _lib.call(
        "mvdf_conv3x3", x, a, b, w9, f32(bias), f32(row),
        None if res is None else res.to(x.dtype).contiguous(), y,
        B, H, W, Cin, Cout, int(act == "silu"), _lib.dtype_code(x.dtype),
    )
    return y


def gn_silu_conv3x3(x, a, b, w, bias, row, res=None, act: str = "silu"):
    """conv3x3(silu(x*a + b)) + bias + row[b] (+ res), NHWC, w the conv's
    (Cout, Cin, 3, 3) parameter: the kernel where _lib.launches (its
    gradient the plain version's), else the plain version."""
    if not _lib.launches(x):
        return conv3x3_plain(x, a, b, w, bias, row, res, act)
    w9 = packed_weight(w, x.dtype)
    y = _lib.with_plain_backward(lambda x, a, b, _, bias, row, res: launch_conv3x3(x, a, b, w9, bias, row, res, act),
                                 lambda *t: conv3x3_plain(*t, act), x, a, b, w, bias, row, res)
    _lib.LAUNCHES["conv3x3"] += 1
    return y
