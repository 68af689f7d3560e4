#!/usr/bin/env python3
"""Smoke test of mvdfusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--steps N] [--eval-steps N] [--forms-steps N] [--profile STEPS]

Phases, each printed with elapsed seconds as it starts and ends:
  1. device   the card's name, count and power limit; exits non-zero
              without a CUDA device or without the package beside it
  2. build    removes any stale build directory, then builds every kernel
              (one nvcc process a source, all started together, then one
              link); prints its seconds and ptxas' registers, shared memory
              and spills per kernel
  3. kernels  each hand-written kernel against its plain PyTorch version at
              the shapes of the flagship and of the eval path in bf16 (and
              at small shapes in fp32),
              with the tolerance stated; times kernel, plain version and,
              where one exists, the one PyTorch call computing the same thing
  4. slice    the full-width model (random weights from a seed, built on the
              card) answers 2 requests: prepare_batch on a 256^2 scene,
              --steps eta=1 DDIM steps for 8 target views at CFG 2.5, decode;
              checks shapes, finiteness, the [0, 1] image range and that every
              kernel's launch count rose by what the path implies
  5. eval     the same model runs the evaluation path (configs/gso.yaml's
              protocol: 1 input view -> 15 target views on the 16-view GSO
              rig, CFG batch 30) on one in-memory scene of random 256^2
              images through pipeline/eval.py::eval_scenes for --eval-steps
              steps, then utils/metrics.py; checks shapes, finiteness, the
              [0, 1] range, finite metrics, and that GridAttn took the
              two-phase K4 form on every step
  6. forms    the same model answers 1 flagship request with the switched
              forms of the transformer site on (MVDF_BLOCK_SINGLE=1: K5 at
              the 32^2 sites; MVDF_BLOCK_BIGC=1: K6 at the C=1280 8^2 sites)
              for --forms-steps steps; checks shapes, finiteness, the [0, 1]
              range and the launch counts, then holds the latents after one
              DDIM step against the default route's on the same noise
  7. vae      the same model's VAE with the reference's switched forms
              (MVDF_GN_TILED=1: the tiled GroupNorm K7 on maps above 2^20
              elements an image; MVDF_CONV3X3=1: the fused GN + SiLU + conv
              K8 in the ResBlocks of maps of at least 64^2): the encode of the
              flagship's 9 images and the decode of 8 latents on the default
              route, with MVDF_GN_TILED=1 alone and with both, then the eval
              path's chunked decode of 15 views (chunks of 8 and 7) with both;
              checks shapes, finiteness, the [0, 1] range and the launch
              counts, and holds each switched result against the default
              route's
The last three lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": ...}.
Comparisons run with TF32 off for matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
HERE = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SEED = 0
REQUESTS = 2  # scenes, one seed each
# VAE GroupNorms whose (HW, C) slice passes K1's gate (HW*C <= 2^20: the 32^2
# levels) in one encode and in one decode call at 256^2
VAE_GN_ENCODE = VAE_GN_DECODE = 11
# the VAE's launches at 256^2 by route (phase 7; PERF.md, Findings): with
# MVDF_GN_TILED=1 the GroupNorms of larger maps take K7; with MVDF_CONV3X3=1
# too, the ResBlocks at 64^2..256^2 (6 in the encoder, 9 in the decoder) take
# K8 (2 folds, 2 convs each) and the encoder's 64^2 x 256 norm1 (K1) goes with
# them; the decoder's 256^2 norm_out stays on K7
VAE_LAUNCHES = {
    "default": {"encode": {"groupnorm": 11}, "decode": {"groupnorm": 11}},
    "gn_tiled": {"encode": {"groupnorm": 11, "groupnorm_tiled": 11},
                 "decode": {"groupnorm": 11, "groupnorm_tiled": 19}},
    "both": {"encode": {"groupnorm": 10, "gn_fold_affine": 12, "conv3x3": 12},
             "decode": {"groupnorm": 11, "groupnorm_tiled": 1, "gn_fold_affine": 18, "conv3x3": 18}},
}
VAE_KERNELS = ("groupnorm", "groupnorm_tiled", "gn_fold_affine", "conv3x3", "attention")
EVAL_TARGETS = 15  # configs/gso.yaml inference.train_batch_size
# the flagship UNet's transformer sites per apply_model_cfg: 8 at 32^2 (C=320),
# 8 at 16^2 (C=640), 8 at 8^2 (C=1280), 2 at the 4^2 middle (N=16, below
# every gate)
SITES_PER_LEVEL = 8
ITERS = 20  # timed launches per kernel after warm-up
VAE_ITERS = 5  # timed encode and decode calls per VAE route after one warm-up


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        log(f"phase {self.name}: end, {time.perf_counter() - self.t:.2f}s, {status}")
        return False


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    total = 0
    for t in ts:
        if isinstance(t, (list, tuple)):
            total += nbytes(*t)
        elif t is not None and hasattr(t, "numel"):
            total += t.numel() * t.element_size()
    return total


def check(ok: bool, msg: str) -> None:
    """A failed check fails the run (not an assert: `python -O` drops those)."""
    if not ok:
        raise AssertionError(msg)


def compare(name, got, want, rtol: float, why: str, dtype) -> float:
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    ok = math.isfinite(err) and err <= rtol * scale
    log(f"  {name} [{dtype}]: max|kernel - plain| = {err:.3e}, tolerance {rtol:g} x max(1, max|plain|) "
        f"= {rtol * scale:.3e} ({why}) -> {'ok' if ok else 'MISS'}")
    check(ok, f"{name}: kernel disagrees with its plain version ({err:.3e})")
    return err


def compare_ulp(name, got, want, why: str) -> float:
    """bf16: |kernel - plain| <= 1 bf16 ulp of max|plain| (each side rounds
    its fp32 result once; the fp32 results differ by far less than an ulp)."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    ok = math.isfinite(err) and err <= ulp
    log(f"  {name} [bf16]: max|kernel - plain| = {err:.3e}, tolerance 1 bf16 ulp of max|plain| {top:.3e} = "
        f"{ulp:.3e} ({why}) -> {'ok' if ok else 'MISS'}")
    check(ok, f"{name}: kernel disagrees with its plain version ({err:.3e})")
    return err


def compare_tokens(name, got, want, bound) -> float:
    """Phase-1 tokens, bf16: |kernel - plain| <= 1 bf16 ulp of the larger
    token (each side rounds its fp32 sum once) + `bound`, the fp32 sums'
    own difference (crossview.gather_tokens_bound). Logs the element that
    comes closest with its parts; returns the largest |diff| in bf16 ulps."""
    got, want = got.float(), want.float()
    mag = got.abs().maximum(want.abs())
    ulp = (mag.clamp_min(2.0**-126).log2().floor() - 7).exp2()
    diff = (got - want).abs()
    ratio = diff / (ulp + bound)
    i = int(ratio.argmax())
    worst = ratio.flatten()[i].item()
    at = lambda t: t.flatten()[i].item()
    ok = math.isfinite(worst) and worst <= 1.0
    log(f"  {name} [bf16]: max|kernel - plain| / (1 ulp + sum bound) = {worst:.3f} at |diff| {at(diff):.3e}, "
        f"token {at(want):.3e}, ulp {at(ulp):.3e}, sum bound {at(bound):.3e}; max {(diff / ulp).max().item():.2f} ulp, "
        f"{(diff > ulp).float().mean().item() * 100:.4f}% of tokens over 1 ulp -> {'ok' if ok else 'MISS'}")
    check(ok, f"{name}: kernel disagrees with its plain version ({worst:.3f} of the allowance)")
    return (diff / ulp).max().item()


# ---------------------------------------------------------------- phase 3
def kernel_checks():
    import torch
    import torch.nn.functional as F

    from mvdfusion_tpu_torch.ops import attention as K2
    from mvdfusion_tpu_torch.ops import block as K3
    from mvdfusion_tpu_torch.ops import crossview as K4
    from mvdfusion_tpu_torch.ops import groupnorm as K1

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s, std=1.0, dt=torch.float32: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    bf = torch.bfloat16
    rows = {}

    # K1 GroupNorm: the UNet's 32^2 C=320 slices at the eval path's CFG batch
    # 2B=30 and the flagship's 2B=16 (timed)
    log(" K1 groupnorm")
    for dt, shape, rtol in ((torch.float32, (2, 64, 96), 1e-4), (bf, (30, 1024, 320), 2e-2),
                            (bf, (16, 1024, 320), 2e-2)):
        x = rnd(*shape, dt=dt) * 3 + 1
        w, b = 1 + rnd(shape[-1], std=0.1), rnd(shape[-1], std=0.1)
        for act, eps in (("silu", 1e-5), ("none", 1e-6)):
            compare(f"groupnorm {shape} act={act} eps={eps}", K1.launch_group_norm(x, w, b, 32, eps, act),
                    K1.group_norm_plain(x, w, b, 32, eps, act), rtol,
                    "fp32 statistics on both sides; bf16 output rounding" if dt == bf else "fp32 sum order", dt)
    err = compare("groupnorm timed", K1.launch_group_norm(x, w, b, 32, 1e-6), K1.group_norm_plain(x, w, b, 32, 1e-6),
                  2e-2, "bf16 output rounding", bf)
    ms = time_ms(lambda: K1.launch_group_norm(x, w, b, 32, 1e-6), ITERS)
    plain_ms = time_ms(lambda: K1.group_norm_plain(x, w, b, 32, 1e-6), ITERS)
    lib_ms = time_ms(lambda: F.group_norm(x.transpose(1, 2), 32, w.to(bf), b.to(bf), 1e-6), ITERS)
    bms, by = bound(10 * x.numel(), 2 * nbytes(x) + nbytes(w, b))
    rows["groupnorm"] = dict(name="groupnorm", route="cuda", source="mvdfusion_tpu_torch/csrc/groupnorm.cu",
                             replaces="mvdfusion_tpu/ops/groupnorm.py:54", max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                             shape="x (16, 1024, 320) bf16, 32 groups, eps 1e-6")

    # K2 attention: CLIP (ragged N=257) and the VAE mid-attention (dh=512)
    log(" K2 attention")
    for dt, (B, N, H, dh), rtol in (
        (torch.float32, (2, 77, 3, 40), 1e-4),
        (torch.float32, (1, 130, 1, 512), 1e-4),
        (bf, (1, 1024, 1, 512), 2e-2),
        (bf, (16, 1024, 8, 40), 2e-2),
        (bf, (1, 257, 16, 64), 2e-2),
    ):
        q, k, v = (rnd(B, N, H, dh, dt=dt) for _ in range(3))
        err = compare(f"attention {(B, N, H, dh)}", K2.launch_attention(q, k, v, dh**-0.5),
                      K2.attention_plain(q, k, v, dh**-0.5), rtol,
                      "plain rounds the probabilities to bf16, the kernel keeps fp32" if dt == bf
                      else "fp32 online vs two-pass softmax", dt)
    ms = time_ms(lambda: K2.launch_attention(q, k, v, dh**-0.5), ITERS)
    plain_ms = time_ms(lambda: K2.attention_plain(q, k, v, dh**-0.5), ITERS)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=dh**-0.5), ITERS)
    bms, by = bound(4 * B * H * N * N * dh, nbytes(q, k, v, q))
    rows["attention"] = dict(name="attention", route="cuda", source="mvdfusion_tpu_torch/csrc/attention.cu",
                             replaces="mvdfusion_tpu/ops/attention.py:172", max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                             shape="q/k/v (1, 257, 16, 64) bf16 (CLIP)")

    # K3 transformer site: 32^2 C=320 (row attn2) and 16^2 C=640 (attn2 map)
    # at the eval path's CFG batch 30 and the flagship's 16 (timed)
    log(" K3 transformer_block")

    def site(B, N, C, dt, a2_map):
        inner = 4 * C
        lin = lambda o, i: rnd(o, i, std=i**-0.5, dt=dt)
        vec = lambda n, s=0.1: rnd(n, std=s)
        w = K3.BlockWeights(
            gn_w=1 + vec(C), gn_b=vec(C), pi_w=lin(C, C), pi_b=vec(C), ln1_w=1 + vec(C), ln1_b=vec(C),
            qkv_w=lin(3 * C, C), out_w=lin(C, C), out_b=vec(C), ln3_w=1 + vec(C), ln3_b=vec(C),
            g_w=lin(2 * inner, C), g_b=vec(2 * inner), f_w=lin(C, inner), f_b=vec(C), po_w=lin(C, C), po_b=vec(C),
        )
        x = rnd(B, N, C, dt=dt)
        a2 = rnd(B, N, C, dt=dt) if a2_map else rnd(B, C, dt=dt)
        return x, a2, w

    for dt, (B, N, C, heads, a2_map), rtol in (
        (torch.float32, (2, 128, 64, 4, False), 1e-4),
        (torch.float32, (2, 128, 64, 8, True), 1e-4),
        (bf, (30, 256, 640, 8, True), 3e-2),
        (bf, (30, 1024, 320, 8, False), 3e-2),
        (bf, (16, 256, 640, 8, True), 3e-2),
        (bf, (16, 1024, 320, 8, False), 3e-2),
    ):
        x, a2, w = site(B, N, C, dt, a2_map)
        err = compare(f"transformer_block B={B} N={N} C={C} a2={'map' if a2_map else 'row'}",
                      K3.launch_transformer_block(x, a2, w, heads), K3.transformer_block_plain(x, a2, w, heads),
                      rtol, "bf16 rounding at the same points; K2's unrounded probabilities, fp32 sums in another "
                      "order" if dt == bf else "fp32 sum order", dt)
    ms = time_ms(lambda: K3.launch_transformer_block(x, a2, w, heads), ITERS)
    plain_ms = time_ms(lambda: K3.transformer_block_plain(x, a2, w, heads), ITERS)
    M, inner = B * N, 4 * C
    flops = 2 * M * C * (6 * C + 3 * inner) + 4 * B * N * N * C
    bms, by = bound(flops, 2 * nbytes(x) + nbytes(a2) + nbytes(*w))
    rows["transformer_block"] = dict(
        name="transformer_block", route="cuda",
        source="mvdfusion_tpu_torch/csrc/block.cu (+ groupnorm.cu, attention.cu)",
        replaces="mvdfusion_tpu/ops/block.py:519", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="x (16, 1024, 320) bf16, 8 heads, attn2 row")

    site_flops = lambda B, N, C: 2 * B * N * C * (6 * C + 3 * 4 * C) + 4 * B * N * N * C

    # K5 one-kernel site: the 32^2 C=320 sites (attn2 row and map) at the eval
    # path's CFG batch 30 and the flagship's 16 (timed)
    log(" K5 transformer_block_single")
    for dt, (B, N, C, heads, a2_map), rtol in (
        (torch.float32, (2, 128, 64, 4, False), 1e-4),
        (torch.float32, (2, 128, 64, 8, True), 1e-4),
        (bf, (30, 1024, 320, 8, False), 3e-2),
        (bf, (16, 1024, 320, 8, True), 3e-2),
        (bf, (16, 1024, 320, 8, False), 3e-2),
    ):
        x, a2, w = site(B, N, C, dt, a2_map)
        err = compare(f"transformer_block_single B={B} N={N} C={C} a2={'map' if a2_map else 'row'}",
                      K3.launch_transformer_block_single(x, a2, w, heads), K3.transformer_block_plain(x, a2, w, heads),
                      rtol, "bf16 rounding at the same points; K2's unrounded probabilities, fp32 sums in another "
                      "order" if dt == bf else "fp32 sum order", dt)
    ms = time_ms(lambda: K3.launch_transformer_block_single(x, a2, w, heads), ITERS)
    split_ms = time_ms(lambda: K3.launch_transformer_block(x, a2, w, heads), ITERS)
    plain_ms = time_ms(lambda: K3.transformer_block_plain(x, a2, w, heads), ITERS)
    bms, by = bound(site_flops(B, N, C), 2 * nbytes(x) + nbytes(a2) + nbytes(*w))
    K3.launch_transformer_block_single(x, a2, w, heads)
    phases = K3.site_phase_ms(x, 4 * C)
    log(f"  transformer_block_single: one launch {ms:.4f} ms, the split form's nine launches {split_ms:.4f} ms "
        f"at the same shape; by phase (block 0's clock): " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))
    rows["transformer_block_single"] = dict(
        name="transformer_block_single", route="cuda",
        source="mvdfusion_tpu_torch/csrc/blockforms.cu (site_kernel; gemm.cuh, attention.cuh)",
        replaces="mvdfusion_tpu/ops/block.py:298", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="x (16, 1024, 320) bf16, 8 heads, attn2 row")

    # K6 big-C site: the C=1280 8^2 sites at CFG batch 30 (attn2 map) and 16
    # (timed), and the 512^2 stretch's C=1280 16^2 sites (N=256); the new
    # attention kernel alone first
    log(" K6 transformer_block_big")
    for dt, (B, N, C, heads, a2_map), rtol in (
        (torch.float32, (2, 64, 128, 4, False), 1e-4),
        (torch.float32, (2, 128, 256, 2, True), 1e-4),
        (bf, (30, 64, 1280, 8, True), 3e-2),
        (bf, (16, 256, 1280, 8, False), 3e-2),
        (bf, (16, 64, 1280, 8, False), 3e-2),
    ):
        x, a2, w = site(B, N, C, dt, a2_map)
        ln1 = rnd(B, N, C, dt=dt)
        attn_err = compare(f"big attention B={B} N={N} C={C} heads={heads}", K3.launch_big_attention(ln1, w.qkv_w, heads),
                           K3.qkv_attention_plain(ln1, w.qkv_w, heads), rtol,
                           "q, k, v and the probabilities rounded at the same points, fp32 sums in another order", dt)
        err = compare(f"transformer_block_big B={B} N={N} C={C} a2={'map' if a2_map else 'row'}",
                      K3.launch_transformer_block_big(x, a2, w, heads), K3.transformer_block_big_plain(x, a2, w, heads),
                      rtol, "bf16 rounding at the same points, fp32 sums in another order" if dt == bf
                      else "fp32 sum order", dt)
    ms = time_ms(lambda: K3.launch_transformer_block_big(x, a2, w, heads), ITERS)
    attn_ms = time_ms(lambda: K3.launch_big_attention(ln1, w.qkv_w, heads), ITERS)
    plain_ms = time_ms(lambda: K3.transformer_block_big_plain(x, a2, w, heads), ITERS)
    bms, by = bound(site_flops(B, N, C), 2 * nbytes(x) + nbytes(a2) + nbytes(*w))
    abms, aby = bound(2 * B * N * C * 3 * C + 4 * B * N * N * C, nbytes(ln1, w.qkv_w, ln1))
    log(f"  transformer_block_big: the attention kernel (projections + attention) {attn_ms:.4f} ms of {ms:.4f} ms, "
        f"its bound {abms:.4f} ms ({aby}), max|err| {attn_err:.3e}")
    rows["transformer_block_big"] = dict(
        name="transformer_block_big", route="cuda",
        source="mvdfusion_tpu_torch/csrc/blockforms.cu (bigattn_kernel) + block.cu + groupnorm.cu",
        replaces="mvdfusion_tpu/ops/block.py:370", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="x (16, 64, 1280) bf16, 8 heads, attn2 row")

    # K4 cross-view aggregation: V=8 views x 32^2 points, hid 256, 3 layers
    log(" K4 crossview")

    def cv_inputs(V, Hh, hid, L, heads, out_dim, dt):
        N, nh, mlp = V * Hh * Hh, 7, 2 * hid
        lin = lambda o, i: rnd(o, i, std=i**-0.5, dt=dt)
        w = K4.AggregatorWeights(
            qkv_w=[lin(3 * hid, hid) for _ in range(L)], qkv_b=[rnd(3 * hid, std=0.1) for _ in range(L)],
            proj_w=[lin(hid, hid) for _ in range(L)], proj_b=[rnd(hid, std=0.1) for _ in range(L)],
            fc1_w=[lin(mlp, hid) for _ in range(L)], fc1_b=[rnd(mlp, std=0.1) for _ in range(L)],
            fc2_w=[lin(hid, mlp) for _ in range(L)], fc2_b=[rnd(hid, std=0.1) for _ in range(L)],
            mods=rnd(L, 6, hid, std=0.5), wl_w=lin(1, hid), wl_b=rnd(1, std=0.1), fin_w=lin(out_dim, hid),
            fin_b=rnd(out_dim, std=0.1),
        )
        G = 7 * (1 + 2 * nh)
        kg = K4.GeoWeights(kall=rnd(G, hid, std=G**-0.5, dt=dt), kmask=rnd(hid, std=0.1))
        args = (rnd(V, N, 2) * 0.6, rnd(N, 3), rnd(V, 3) * 2, torch.ones(V, device=dev), rnd(N, hid, dt=dt),
                rnd(V, Hh, Hh, hid, dt=dt), kg, w, heads, tuple(0.1 * 2.0**i for i in range(nh)))
        return args, N, mlp, G

    for dt, (V, Hh, hid, L, heads, out_dim), rtol in (
        (torch.float32, (3, 8, 64, 2, 4, 48), 1e-4),
        (bf, (8, 32, 256, 3, 8, 768), 3e-2),
    ):
        args, N, mlp, G = cv_inputs(V, Hh, hid, L, heads, out_dim, dt)
        err = compare(f"crossview V={V} N={N} hid={hid}", K4.launch_crossview(*args), K4.crossview_plain(*args),
                      rtol, "bf16 operands, fp32 residual stream on both sides" if dt == bf else "fp32 sum order", dt)
    ms = time_ms(lambda: K4.launch_crossview(*args), ITERS)
    plain_ms = time_ms(lambda: K4.crossview_plain(*args), max(2, ITERS // 4))
    T = N * V
    flops = (2 * T * (G + 4) * hid + L * (2 * T * hid * (4 * hid + 2 * mlp) + 4 * T * V * hid)
             + 2 * N * hid * out_dim)
    bms, by = bound(flops, nbytes(*args[:6]) + nbytes(*args[6]) + nbytes(*args[7]) + N * out_dim * 2)
    rows["crossview"] = dict(
        name="crossview", route="cuda",
        source="mvdfusion_tpu_torch/csrc/crossview.cu (+ block.cu)",
        replaces="mvdfusion_tpu/ops/crossview.py:562", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="V=8, N=8192, hid 256, 3 layers, 8 heads, out 768, bf16")
    # K4b cross-view aggregation, two-phase form: the 15-view evaluation
    # (V=15 x 32^2 points); phase-1 tokens held to 1 bf16 ulp
    log(" K4b crossview_two_phase")
    for dt, (V, Hh, hid, L, heads, out_dim), rtol in (
        (torch.float32, (3, 8, 64, 2, 4, 48), 1e-4),
        (bf, (15, 32, 256, 3, 8, 768), 3e-2),
    ):
        args, N, mlp, G = cv_inputs(V, Hh, hid, L, heads, out_dim, dt)
        geo_args = args[:4] + (args[5], args[6], args[9])  # xy, pts, centers, mask, maps_p, kg, freqs
        tok = K4.launch_gather_tokens(*geo_args)
        tok_plain = K4.gather_tokens_plain(*geo_args).to(dt).transpose(0, 1)
        if dt == bf:
            compare_tokens(f"crossview_two_phase phase-1 tokens V={V} N={N}", tok, tok_plain,
                           K4.gather_tokens_bound(*geo_args).transpose(0, 1))
        else:
            compare(f"crossview_two_phase phase-1 tokens V={V} N={N}", tok, tok_plain, 1e-4, "fp32 sum order", dt)
        err = compare(f"crossview_two_phase V={V} N={N} hid={hid}", K4.launch_crossview_two_phase(*args),
                      K4.crossview_two_phase_plain(*args), rtol,
                      "bf16 operands, tokens rounded at the same point, fp32 residual stream on both sides"
                      if dt == bf else "fp32 sum order", dt)
    ms = time_ms(lambda: K4.launch_crossview_two_phase(*args), ITERS)
    phase1_ms = time_ms(lambda: K4.launch_gather_tokens(*geo_args), ITERS)
    plain_ms = time_ms(lambda: K4.crossview_two_phase_plain(*args), max(2, ITERS // 4))
    T = N * V
    flops = (2 * T * (G + 4) * hid + L * (2 * T * hid * (4 * hid + 2 * mlp) + 4 * T * V * hid)
             + 2 * N * hid * out_dim)
    bms, by = bound(flops, nbytes(*args[:6]) + nbytes(*args[6]) + nbytes(*args[7]) + N * out_dim * 2)
    log(f"  crossview_two_phase: phase 1 (gather + geometry, bf16 tokens) {phase1_ms:.4f} ms of {ms:.4f} ms; "
        f"{flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s")
    rows["crossview_two_phase"] = dict(
        name="crossview_two_phase", route="cuda",
        source="mvdfusion_tpu_torch/csrc/crossview.cu (+ block.cu)",
        replaces="mvdfusion_tpu/ops/crossview.py:404", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None,
        shape="V=15, N=15360, hid 256, 3 layers, 8 heads, out 768, bf16")
    rows.update(vae_kernel_checks(rnd))
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms at {r['shape']}")
    return rows


def vae_kernel_checks(rnd):
    """K7 and K8 against their plain versions at the VAE's shapes in bf16 (and
    small ragged shapes in fp32), timed at the decoder's largest maps."""
    import torch
    import torch.nn.functional as F

    from mvdfusion_tpu_torch.ops import conv3x3 as K8
    from mvdfusion_tpu_torch.ops import groupnorm as K1

    bf = torch.bfloat16
    rows = {}
    why = lambda dt: ("fp32 statistics on both sides, sums in another order; bf16 output rounding" if dt == bf
                      else "fp32 sum order")

    # K7 tiled GroupNorm: a ragged last row tile in fp32; the encoder's
    # 128^2 x 256 maps (B=9), the decoder's 64^2 x 512 and its 256^2 x 128
    # norm_out (timed, act none as K1's row)
    log(" K7 groupnorm_tiled")
    err = 0.0
    for dt, shape in ((torch.float32, (2, 3000, 96)), (bf, (9, 16384, 256)), (bf, (8, 4096, 512)),
                      (bf, (8, 65536, 128))):
        x = rnd(*shape, dt=dt) * 3 + 1
        w, b = 1 + rnd(shape[-1], std=0.1), rnd(shape[-1], std=0.1)
        for act in ("silu", "none"):
            name = f"groupnorm_tiled {shape} act={act}"
            got = K1.launch_group_norm_tiled(x, w, b, 32, 1e-6, act)
            want = K1.group_norm_tiled_plain(x, w, b, 32, 1e-6, act)
            err = max(err, compare_ulp(name, got, want, why(dt)) if dt == bf
                      else compare(name, got, want, 1e-4, why(dt), dt))
    ms = time_ms(lambda: K1.launch_group_norm_tiled(x, w, b, 32, 1e-6), ITERS)
    stats_ms = time_ms(lambda: K1.launch_fold(x, w, b, 32, 1e-6, True), ITERS)
    a, sh = K1.launch_fold(x, w, b, 32, 1e-6, True)
    apply_ms = time_ms(lambda: K1.launch_apply_affine(x, a, sh), ITERS)
    plain_ms = time_ms(lambda: K1.group_norm_tiled_plain(x, w, b, 32, 1e-6), ITERS)
    lib_ms = time_ms(lambda: F.group_norm(x.transpose(1, 2), 32, w.to(bf), b.to(bf), 1e-6), ITERS)
    bms, by = bound(10 * x.numel(), 2 * nbytes(x) + nbytes(w, b))
    log(f"  groupnorm_tiled: stats pass with the fold {stats_ms:.4f} ms, apply pass {apply_ms:.4f} ms, of {ms:.4f} ms; "
        f"the two passes' own floor (two reads and one write of x) {3 * nbytes(x) / PEAK_BYTES * 1e3:.4f} ms")
    rows["groupnorm_tiled"] = dict(
        name="groupnorm_tiled", route="cuda",
        source="mvdfusion_tpu_torch/csrc/groupnorm.cu (gn_stats_partial_kernel, gn_fold_kernel, "
               "gn_apply_kernel)",
        replaces="mvdfusion_tpu/ops/groupnorm.py:104", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, shape="x (8, 65536, 128) bf16, 32 groups, eps 1e-6 (the decoder's norm_out)")

    # K8 statistics: the eval chunk's 128^2 x 512 (B=7) and the decoder's
    # 256^2 x 256 (timed); the fold's outputs are fp32 on both sides
    log(" K8 gn_fold_affine")
    err = 0.0
    for dt, shape in ((torch.float32, (2, 3000, 96)), (bf, (7, 16384, 512)), (bf, (8, 65536, 256))):
        x = rnd(*shape, dt=dt) * 3 + 1
        w, b = 1 + rnd(shape[-1], std=0.1), rnd(shape[-1], std=0.1)
        (ka, kb), (pa, pb) = K8.launch_gn_fold_affine(x, w, b, 32, 1e-6), K8.gn_fold_affine_plain(x, w, b, 32, 1e-6)
        err = max(err, compare(f"gn_fold_affine {shape} a", ka, pa, 1e-4, "fp32 sums in another order", dt),
                  compare(f"gn_fold_affine {shape} b", kb, pb, 1e-4, "fp32 sums in another order", dt))
    ms = time_ms(lambda: K8.launch_gn_fold_affine(x, w, b, 32, 1e-6), ITERS)
    plain_ms = time_ms(lambda: K8.gn_fold_affine_plain(x, w, b, 32, 1e-6), ITERS)
    bms, by = bound(3 * x.numel(), nbytes(x, w, b, ka, kb))
    rows["gn_fold_affine"] = dict(
        name="gn_fold_affine", route="cuda",
        source="mvdfusion_tpu_torch/csrc/groupnorm.cu (gn_stats_partial_kernel, gn_fold_kernel)",
        replaces="mvdfusion_tpu/ops/conv3x3.py:62", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="x (8, 65536, 256) bf16, 32 groups")

    # K8 conv: ragged tiles in fp32 (TX 32 x TR 4 over 20 x 40; TX 128 over
    # W = 136, odd H, Cout 8), the eval chunk's 64^2 x 512 with a residual,
    # the decoder's 64^2 x 512 and its 256^2 256 -> 128 with the nin residual
    # (timed)
    log(" K8 conv3x3")
    err = 0.0

    def conv_inputs(B, H, W, Cin, Cout, dt, with_res):
        x = rnd(B, H, W, Cin, dt=dt)
        a, b = 1 + rnd(B, Cin, std=0.3), rnd(B, Cin, std=0.2)
        w = rnd(Cout, Cin, 3, 3, std=(9 * Cin) ** -0.5, dt=dt)
        res = rnd(B, H, W, Cout, dt=dt) if with_res else None
        return x, a, b, w, rnd(Cout, std=0.1), rnd(B, Cout, std=0.1), res

    conv_flops = lambda x, w: 2 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[0] * w.shape[1] * 9
    for dt, shape, rtol in ((torch.float32, (2, 20, 40, 32, 64, True), 1e-4),
                            (torch.float32, (3, 13, 136, 64, 8, False), 1e-4),
                            (bf, (7, 64, 64, 512, 512, True), 3e-2), (bf, (8, 64, 64, 512, 512, False), 3e-2),
                            (bf, (8, 256, 256, 256, 128, True), 3e-2)):
        x, a, b, w, bias, row, res = args = conv_inputs(*shape[:5], dt, shape[5])
        w9 = K8.pack_weight(w, dt)
        err = max(err, compare(f"conv3x3 {shape[:4]} -> {shape[4]}{' + res' if res is not None else ''}",
                               K8.launch_conv3x3(x, a, b, w9, bias, row, res), K8.conv3x3_plain(*args), rtol,
                               "bf16 operands rounded at the same point, fp32 sums in another order" if dt == bf
                               else "fp32 sum order", dt))
        if shape == (8, 64, 64, 512, 512, False):
            ms64 = time_ms(lambda: K8.launch_conv3x3(x, a, b, w9, bias, row, res), ITERS)
            b64 = bound(conv_flops(x, w), 2 * nbytes(x) + nbytes(w9))[0]
            log(f"  conv3x3 (8, 64, 64, 512 -> 512): {ms64:.4f} ms, {conv_flops(x, w) / ms64 / 1e9:.1f} TFLOP/s, "
                f"bound {b64:.4f} ms")
    ms = time_ms(lambda: K8.launch_conv3x3(x, a, b, w9, bias, row, res), ITERS)
    plain_ms = time_ms(lambda: K8.conv3x3_plain(*args), max(2, ITERS // 4))
    xn, wn = x.permute(0, 3, 1, 2), w.contiguous(memory_format=torch.channels_last)
    lib_ms = time_ms(lambda: F.conv2d(xn, wn, bias.to(bf), padding=1), ITERS)
    flops = conv_flops(x, w)
    bms, by = bound(flops, nbytes(x, res, w9, a, b, bias, row) + x.numel() // x.shape[-1] * w.shape[0] * 2)
    log(f"  conv3x3: {flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s; the library yardstick is F.conv2d "
        f"(cuDNN, channels-last bf16) + bias without the prologue and residual")
    rows["conv3x3"] = dict(
        name="conv3x3", route="cuda", source="mvdfusion_tpu_torch/csrc/conv3x3.cu",
        replaces="mvdfusion_tpu/ops/conv3x3.py:95", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, shape="x (8, 256, 256, 256) bf16 -> 128 channels, + residual")
    return rows


# ---------------------------------------------------------------- phase 4
def build_model(device: str = "cuda", cfg=None):
    """The full-width model (or `cfg`) with random weights from SEED, towers
    cast to cfg.dtype."""
    import torch

    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_

    cfg = cfg or ViewFusionConfig()
    model = randomize_(ViewFusion(cfg, device=torch.device(device)), SEED).cast_for_inference().eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  ViewFusion built on {device}: {n_params / 1e9:.3f} B parameters, towers in {cfg.dtype}")
    return model


def flagship_scene(model, dev):
    """The flagship request's rig: 9 views on a ring at 20 degrees of
    elevation, view 0 the input, views 1-8 the targets."""
    import numpy as np
    import torch

    from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform

    S = 9
    R, T = look_at_view_transform(dist=1.5, elev=20.0, azim=np.linspace(0, 360, S, endpoint=False) + 90)
    return dict(R=torch.tensor(R, device=dev), T=torch.tensor(T, device=dev), f=torch.full((S, 2), 2.1875, device=dev),
                c=torch.zeros(S, 2, device=dev), input_idx=torch.tensor([0], device=dev),
                target_idx=torch.arange(1, S, device=dev))


def answer(model, scene, steps: int, seed: int, dev):
    """One flagship request on random images from `seed`: prepare_batch,
    `steps` eta=1 DDIM steps at CFG 2.5, decode; checks shapes, finiteness and
    the [0, 1] image range. Returns the latents, the prepared sampler inputs
    and the seconds of each part."""
    import torch

    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    cfg = model.cfg
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    S, B, ls = 9, 8, cfg.latent_size
    IMG = ls * 2 ** (len(cfg.vae_ch_mult) - 1)
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.rand(S, IMG, IMG, 3, generator=g, device=dev)
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        batch_latents, *prepared = model.prepare_batch(images, scene["R"], scene["T"], scene["f"], scene["c"],
                                                       scene["input_idx"], scene["target_idx"])
        sync()
        t1 = time.perf_counter()
        res = ddim_sample(model, *prepared, 2.5, num_steps=steps, generator=g)
        sync()
        t2 = time.perf_counter()
        imgs = model.decode_latents(res.latents[..., :4])
        sync()
        t3 = time.perf_counter()
    lat = res.latents
    log(f"  request (seed {seed}): prepare {t1 - t0:.3f}s, {steps} steps {t2 - t1:.3f}s "
        f"({(t2 - t1) / steps:.4f} s/step), decode {t3 - t2:.3f}s; max|latent| {lat.abs().max().item():.3f}, "
        f"image range [{imgs.min().item():.4f}, {imgs.max().item():.4f}]")
    check(tuple(batch_latents.shape) == (B, ls, ls, 5) and tuple(lat.shape) == (B, ls, ls, 5),
          f"latent shape {tuple(lat.shape)}")
    check(tuple(imgs.shape) == (B, IMG, IMG, 3), f"image shape {tuple(imgs.shape)}")
    check(bool(torch.isfinite(lat).all() and torch.isfinite(imgs).all()), "non-finite output")
    check(bool(imgs.min() >= 0 and imgs.max() <= 1), "images outside [0, 1]")
    return lat, prepared, (t1 - t0, t2 - t1, t3 - t2)


def run_slice(steps: int, card: str, device: str = "cuda", cfg=None, profile: int = 0, model=None):
    """Drive the port's main path; `device`/`cfg` let the same code be
    rehearsed on the CPU at the tiny config (launch counts are then 0)."""
    import torch

    from mvdfusion_tpu_torch.ops import _lib

    dev = torch.device(device)
    model = model if model is not None else build_model(device, cfg)
    scene = flagship_scene(model, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    step_s, req_s = [], []
    for r in range(REQUESTS):
        _, prepared, (tp, ts, td) = answer(model, scene, steps, SEED + 1 + r, dev)
        step_s.append(ts / steps)
        req_s.append(tp + ts + td)
    counts = dict(_lib.LAUNCHES)
    if dev.type != "cuda":
        return counts
    # launches the path implies at this config (PERF.md, Findings):
    #  groupnorm: 55 UNet GroupNorms per step (44 in 22 ResBlocks, 10 C=1280
    #    site norms, norm_out) + 22 VAE GroupNorms with HW*C <= 2^20 per scene
    #  attention: 24 CLIP layers per scene (the VAE's dh=512 heads run at
    #    batch 9 and 8, outside the gate)
    #  transformer_block: 16 sites per step (8 at 32^2 C=320, 8 at 16^2 C=640)
    #  crossview: 1 per step, the single form (8 views: 4 MiB of maps)
    want = {
        "groupnorm": REQUESTS * (steps * 55 + VAE_GN_ENCODE + VAE_GN_DECODE),
        "attention": REQUESTS * 24,
        "transformer_block": REQUESTS * steps * 2 * SITES_PER_LEVEL,
        "crossview": REQUESTS * steps,
        "crossview_two_phase": 0,
        "transformer_block_single": 0,
        "transformer_block_big": 0,
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    if profile:
        profile_steps(model, prepared, profile)
    B = len(scene["target_idx"])
    mean = lambda a: sum(a) / len(a)
    log(f"  slice: {mean(step_s):.4f} s/step, {B / mean(req_s):.3f} views/s ({REQUESTS} requests of {B} views, "
        f"{steps} steps), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")
    return counts


# ---------------------------------------------------------------- phase 5
def run_eval(steps: int, card: str, device: str = "cuda", cfg=None, model=None):
    """The evaluation path on one in-memory scene: the 16-view GSO rig,
    random 256^2 images from a numpy seed, 1 input and 15 target views
    (cli/demo.py's split), eval_scenes, then the quality and consistency
    metrics. `device`/`cfg` let it be rehearsed on the CPU at the tiny config."""
    import numpy as np
    import torch

    from mvdfusion_tpu_torch.data.rigs import AZIMUTHS_16, ELEVATIONS_16, fixed_rig
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.ops.crossview import crossview_route
    from mvdfusion_tpu_torch.ops.image import area_downsample
    from mvdfusion_tpu_torch.pipeline.eval import eval_scenes
    from mvdfusion_tpu_torch.utils.metrics import cross_view_consistency, perceptual_distance, psnr, ssim

    dev = torch.device(device)
    model = model if model is not None else build_model(device, cfg)
    cfg = model.cfg
    ls, B = cfg.latent_size, EVAL_TARGETS
    IMG = ls * 2 ** (len(cfg.vae_ch_mult) - 1)
    R, T, f, c = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)
    images = np.random.default_rng(SEED).uniform(size=(1, 16, IMG, IMG, 3)).astype(np.float32)
    sel = np.linspace(0, 15, 1 + B).astype(np.int64)
    on = lambda a: torch.as_tensor(a, device=dev)
    route = crossview_route(B, ls, ls, cfg.viewattn_hidden, cfg.dtype)
    log(f"  scene: 16-view GSO rig, images {IMG}^2, input view {sel[0]}, targets {sel[1:].tolist()}; "
        f"GridAttn route at V={B}: {route}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    timings = []
    out = eval_scenes(model, on(images), on(R[None]), on(T[None]), on(f[None]), on(c[None]), on(sel[:1]),
                      on(sel[1:]), 2.5, num_steps=steps, generators=[torch.Generator(device=dev).manual_seed(SEED)],
                      timings=timings)
    counts = dict(_lib.LAUNCHES)
    o = {k: v[0].float().cpu().numpy() for k, v in out._asdict().items()}
    t = timings[0]
    log(f"  scene: prepare {t['prepare']:.3f}s, {steps} steps {t['sample']:.3f}s ({t['sample'] / steps:.4f} s/step), "
        f"decode {t['decode']:.3f}s, {sum(t.values()):.3f} s/scene; image range "
        f"[{o['pred_rgb'].min():.4f}, {o['pred_rgb'].max():.4f}]")
    check(o["pred_rgb"].shape == (B, IMG, IMG, 3) and o["gt_rgb"].shape == (B, IMG, IMG, 3),
          f"image shape {o['pred_rgb'].shape}")
    check(o["pred_depth"].shape == (B, ls, ls, 1) and o["gt_depth"].shape == (B, ls, ls, 1),
          f"depth shape {o['pred_depth'].shape}")
    check(o["input_depth"].shape == (1, ls, ls, 1), f"input depth shape {o['input_depth'].shape}")
    check(all(np.isfinite(v).all() for v in o.values()), "non-finite output")
    check(all(v.min() >= 0 and v.max() <= 1 for v in o.values()), "outputs outside [0, 1]")
    rgb_lr = area_downsample(torch.as_tensor(o["pred_rgb"]), IMG // ls).numpy()
    cons = cross_view_consistency(rgb_lr, o["pred_depth"], R[sel[1:]], T[sel[1:]], f[sel[1:]], c[sel[1:]])
    metrics = dict(psnr=psnr(o["pred_rgb"], o["gt_rgb"]), ssim=ssim(o["pred_rgb"], o["gt_rgb"]),
                   perceptual=perceptual_distance(o["pred_rgb"], o["gt_rgb"]), photo_mae=cons["photo_mae"],
                   depth_agree_rate=cons["depth_agree_rate"], covis_frac=cons["covis_frac"])
    log("  metrics (random weights): " + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric {metrics}")
    if dev.type != "cuda":
        return counts
    chunks = -(-B // 8)  # decode_latents_chunked's chunks of 8, for prediction and ground truth
    want = {
        "groupnorm": steps * 55 + VAE_GN_ENCODE + 2 * chunks * VAE_GN_DECODE,
        "attention": 24,  # CLIP; the VAE's dh=512 heads run at batch >= 2, outside K2's gate
        "transformer_block": steps * 16,
        "crossview_two_phase": steps,
        "crossview": 0,
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    log(f"  eval: {t['sample'] / steps:.4f} s/step, {sum(t.values()):.3f} s/scene ({B} target views, {steps} steps, "
        f"CFG batch {2 * B}), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")
    return counts


# ---------------------------------------------------------------- phase 6
FORM_SWITCHES = ("MVDF_BLOCK_SINGLE", "MVDF_BLOCK_BIGC")


def set_forms(on: bool) -> None:
    """Switch the transformer site's one-kernel and big-C forms on or off (the
    reference's variables, read by ops/block.py when a site runs)."""
    import os

    for var in FORM_SWITCHES:
        if on:
            os.environ[var] = "1"
        else:
            os.environ.pop(var, None)


def run_forms(steps: int, card: str, device: str = "cuda", cfg=None, profile: int = 0, model=None):
    """The flagship request with both switched forms on, then one DDIM step on
    the same noise with the forms on and off. `device`/`cfg` let it be
    rehearsed on the CPU at the tiny config (launch counts are then 0)."""
    import torch

    from mvdfusion_tpu_torch.core.schedule import ddim_step, make_ddim_schedule
    from mvdfusion_tpu_torch.ops import _lib

    dev = torch.device(device)
    model = model if model is not None else build_model(device, cfg)
    cfg = model.cfg
    scene = flagship_scene(model, dev)
    try:
        set_forms(True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        _, prepared, (tp, ts, td) = answer(model, scene, steps, SEED + 1, dev)
        counts = dict(_lib.LAUNCHES)
        # one DDIM step (the first of a --forms-steps schedule) from the same
        # latents and noise, forms on, then off
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        B, ls = len(scene["target_idx"]), cfg.latent_size
        x, noise = (torch.randn(B, ls, ls, 5, generator=g, device=dev) for _ in range(2))
        jitter = torch.randn(B, ls, ls, cfg.n_pts_per_ray, generator=g, device=dev)
        ddim = make_ddim_schedule(cfg.timesteps, steps, cfg.linear_start, cfg.linear_end, device=dev)
        index = steps - 1
        after = {}
        for on in (True, False):
            set_forms(on)
            with torch.no_grad():
                eps = model.apply_model_cfg(x, *prepared, ddim.timesteps[index].expand(B), 2.5, jitter)
                after[on] = ddim_step(ddim, x, eps, index, noise)[0]
    finally:
        set_forms(False)
    step_err = compare(f"latents after one DDIM step (t={int(ddim.timesteps[index])}), forms on vs the default route",
                       after[True], after[False], 3e-2,
                       "bf16 rounding at other points at 16 of the 26 sites: K5 against K3 (sums in another "
                       "order), K6 against the module path (the reference kernels' rounding points against "
                       "flax's)", cfg.dtype)
    if dev.type != "cuda":
        return counts
    # per step: K5 at the 8 32^2 sites, K6 at the 8 C=1280 8^2 sites, K3 at
    # the 8 16^2 sites; the 8^2 site norms move into K6, so 47 UNet K1 calls
    want = {
        "transformer_block_single": steps * SITES_PER_LEVEL,
        "transformer_block_big": steps * SITES_PER_LEVEL,
        "transformer_block": steps * SITES_PER_LEVEL,
        "groupnorm": steps * (55 - SITES_PER_LEVEL) + VAE_GN_ENCODE + VAE_GN_DECODE,
        "attention": 24,
        "crossview": steps,
        "crossview_two_phase": 0,
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    if profile:
        set_forms(True)
        try:
            profile_steps(model, prepared, profile)
        finally:
            set_forms(False)
    log(f"  forms: {ts / steps:.4f} s/step, {B / (tp + ts + td):.3f} views/s (1 request of {B} views, {steps} steps), "
        f"one-step latent gap {step_err:.3e}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"on {card}")
    return counts


# ---------------------------------------------------------------- phase 7
VAE_SWITCHES = ("MVDF_GN_TILED", "MVDF_CONV3X3")
VAE_ROUTES = {"default": (False, False), "gn_tiled": (True, False), "both": (True, True)}


def set_vae_forms(gn_tiled: bool, conv: bool) -> None:
    """Switch the VAE's tiled GroupNorm and fused conv on or off (the
    reference's variables, read by ops/groupnorm.py and ops/conv3x3.py when a
    GroupNorm or a ResBlock runs)."""
    import os

    for var, on in zip(VAE_SWITCHES, (gn_tiled, conv)):
        if on:
            os.environ[var] = "1"
        else:
            os.environ.pop(var, None)


def run_vae(card: str, device: str = "cuda", cfg=None, model=None):
    """The VAE on each route: encode of the flagship's 9 images, decode of 8
    latents, and with both forms on the eval path's chunked decode of 15
    views; every switched result against the default route's on the same
    inputs. Returns the launches of the whole phase. `device`/`cfg` let it be
    rehearsed on the CPU at the tiny config (launch counts are then 0)."""
    import collections

    import torch

    from mvdfusion_tpu_torch.ops import _lib

    dev = torch.device(device)
    model = model if model is not None else build_model(device, cfg)
    cfg = model.cfg
    ls = cfg.latent_size
    IMG = ls * 2 ** (len(cfg.vae_ch_mult) - 1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    images = torch.rand(9, IMG, IMG, 3, generator=g, device=dev)
    z = torch.randn(8, ls, ls, 4, generator=g, device=dev)
    z15 = torch.randn(EVAL_TARGETS, ls, ls, 4, generator=g, device=dev)
    total, out, counts, secs = collections.Counter(), {}, {}, {}

    def run(key, fn, *a):
        _lib.reset_launches()
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            out[key] = fn(*a)
        sync()
        secs[key] = time.perf_counter() - t0
        counts[key] = dict(_lib.LAUNCHES)
        total.update(_lib.LAUNCHES)

    try:
        for route, switches in VAE_ROUTES.items():
            set_vae_forms(*switches)
            run((route, "encode"), model.encode_images, images)
            run((route, "decode"), model.decode_latents, z)
            if route != "gn_tiled":
                run((route, "decode_15"), model.decode_latents_chunked, z15)
    finally:
        set_vae_forms(False, False)
    for (route, what), t in secs.items():
        log(f"  vae {route}: {what} {t:.4f}s, launches {counts[(route, what)]}")
    for key, o in out.items():
        n = 15 if key[1] == "decode_15" else (9 if key[1] == "encode" else 8)
        want = (n, ls, ls, 4) if key[1] == "encode" else (n, IMG, IMG, 3)
        check(tuple(o.shape) == want, f"{key}: shape {tuple(o.shape)}, expected {want}")
        check(bool(torch.isfinite(o).all()), f"{key}: non-finite output")
        if key[1] != "encode":
            check(bool(o.min() >= 0 and o.max() <= 1), f"{key}: images outside [0, 1]")
    gaps = {}
    for key, o in out.items():
        if key[0] != "default":
            gaps[key] = compare(f"vae {key[1]}, {key[0]} vs the default route", o, out[("default", key[1])], 3e-2,
                                "bf16 rounding at other points: K7's folded affine, K8's single rounding after "
                                "conv + bias + residual", cfg.dtype)
    if dev.type != "cuda":
        return {}
    chunks = -(-EVAL_TARGETS // 8)  # decode_latents_chunked's chunks of 8
    for (route, what), launched in counts.items():
        per_decode = VAE_LAUNCHES[route]["decode" if what == "decode_15" else what]
        want = {k: per_decode.get(k, 0) * (chunks if what == "decode_15" else 1) for k in VAE_KERNELS}
        got = {k: launched.get(k, 0) for k in VAE_KERNELS}
        check(got == want, f"vae {route} {what}: launches {got}, the path implies {want}")
    log(f"  vae: largest gap to the default route {max(gaps.values()):.3e}, on {card}")
    vae_route_times(model, images, z, card)
    return dict(total)


def vae_route_times(model, images, z, card: str) -> None:
    """Host time of encode (9 images) and decode (8 latents) per VAE route:
    one warm-up call (with both forms on, the call that packs each conv
    weight, so packing is excluded), then VAE_ITERS calls, each timed alone
    between device syncs; logs the median and the spread."""
    import statistics

    import torch

    try:
        for route, switches in VAE_ROUTES.items():
            set_vae_forms(*switches)
            for what, fn, arg in (("encode", model.encode_images, images), ("decode", model.decode_latents, z)):
                ts = []
                with torch.no_grad():
                    fn(arg)
                    for _ in range(VAE_ITERS):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn(arg)
                        torch.cuda.synchronize()
                        ts.append((time.perf_counter() - t0) * 1e3)
                log(f"  vae {route} {what}: median {statistics.median(ts):.4f} ms, min {min(ts):.4f}, "
                    f"max {max(ts):.4f} over {VAE_ITERS} calls after one warm-up, on {card}")
    finally:
        set_vae_forms(False, False)


def profile_steps(model, prepared, steps: int, top: int = 18) -> None:
    """torch.profiler over `steps` sampling steps: device time by kernel name
    per step, and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            ddim_sample(model, *prepared, 2.5, num_steps=steps, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # kernel events only (device_type CUDA): an aten op's self device time
    # repeats the time of the kernels it launched
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    if not events:
        log("  profile: the trace holds no device events (device time not measured)")
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    log(f"  profile of {steps} steps: wall {wall / steps * 1e3:.2f} ms/step (profiled), device busy "
        f"{busy / steps * 1e3:.2f} ms/step = {100 * busy / wall:.1f}% of wall")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"    {dev_us(e) / steps / 1e3:9.3f} ms/step {e.count / steps:7.1f} calls/step  {e.key[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10, help="DDIM steps per request (50 is the flagship)")
    ap.add_argument("--eval-steps", type=int, default=10,
                    help="DDIM steps of the evaluation scene (50 is the paper's protocol)")
    ap.add_argument("--forms-steps", type=int, default=5,
                    help="DDIM steps of the request with the switched transformer-site forms on")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS sampling steps with torch.profiler, on the default "
                         "route (slice) and with the switched forms on (forms)")
    args = ap.parse_args()

    if not (HERE / "mvdfusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the mvdfusion_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    with Phase("device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            raise SystemExit(3)
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        card = smi[0].strip() if smi else kind
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"  {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    from mvdfusion_tpu_torch.ops import _lib

    set_forms(False)  # the slice and eval phases take the default route
    set_vae_forms(False, False)
    with Phase("build"):
        shutil.rmtree(_lib.BUILD_DIR, ignore_errors=True)
        info = _lib.build(force=True)
        _lib.lib()
        log(f"  {len(_lib._sources())} nvcc compiles in parallel and one link, {info['seconds']:.2f}s -> {info['path']}")
        for line in info["log"].splitlines():
            if "Compiling entry function" in line or "Used" in line or "spill" in line:
                log("  ptxas " + line.split("ptxas info    :")[-1].strip())

    with Phase("kernels"):
        rows = kernel_checks()

    with Phase("slice"):
        model = build_model()
        counts = run_slice(args.steps, card, profile=args.profile, model=model)

    with Phase("eval"):
        eval_counts = run_eval(args.eval_steps, card, model=model)
        found = {}
        for mod in ("yaml", "PIL", "imageio"):
            try:
                importlib.import_module(mod)
                found[mod] = "yes"
            except ImportError:
                found[mod] = "no"
        log("  modules for the demo CLI on this machine: " + ", ".join(f"{k} {v}" for k, v in found.items()))

    with Phase("forms"):
        forms_counts = run_forms(args.forms_steps, card, profile=args.profile, model=model)

    with Phase("vae"):
        vae_counts = run_vae(card, model=model)

    # launches of the phase that drives each kernel's path: the flagship
    # slice for K1-K4, the evaluation scene for the two-phase K4, the forms
    # request for K5 and K6, the VAE phase for K7 and K8
    phase_of = {"crossview_two_phase": eval_counts, "transformer_block_single": forms_counts,
                "transformer_block_big": forms_counts, "groupnorm_tiled": vae_counts, "gn_fold_affine": vae_counts,
                "conv3x3": vae_counts}
    for name, r in rows.items():
        r["launches"] = phase_of.get(name, counts).get(name, 0)
        r.pop("shape")
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
