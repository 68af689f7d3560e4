#!/usr/bin/env python3
"""Smoke test of mvdfusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--steps N] [--eval-steps N] [--profile STEPS]

Phases, each printed with elapsed seconds as it starts and ends:
  1. device   the card's name, count and power limit; exits non-zero
              without a CUDA device or without the package beside it
  2. build    removes any stale build directory, then builds every kernel
              with one nvcc call; prints its seconds and ptxas' registers,
              shared memory and spills per kernel
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
The last two lines are the kernels' JSON record and {"ok": true, "device": ...}.
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
EVAL_TARGETS = 15  # configs/gso.yaml inference.train_batch_size
ITERS = 20  # timed launches per kernel after warm-up


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
                      rtol, "bf16 rounding at different points of 6 chained products" if dt == bf
                      else "fp32 sum order", dt)
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
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms at {r['shape']}")
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


def run_slice(steps: int, card: str, device: str = "cuda", cfg=None, profile: int = 0, model=None):
    """Drive the port's main path; `device`/`cfg` let the same code be
    rehearsed on the CPU at the tiny config (launch counts are then 0)."""
    import numpy as np
    import torch

    from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = model if model is not None else build_model(device, cfg)
    cfg = model.cfg
    S, B, ls = 9, 8, cfg.latent_size
    IMG = ls * 2 ** (len(cfg.vae_ch_mult) - 1)
    R, T = look_at_view_transform(dist=1.5, elev=20.0, azim=np.linspace(0, 360, S, endpoint=False) + 90)
    R, T = torch.tensor(R, device=dev), torch.tensor(T, device=dev)
    f = torch.full((S, 2), 2.1875, device=dev)
    c = torch.zeros(S, 2, device=dev)
    input_idx = torch.tensor([0], device=dev)
    target_idx = torch.arange(1, S, device=dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    step_s, req_s = [], []
    for r in range(REQUESTS):
        g = torch.Generator(device=dev).manual_seed(SEED + 1 + r)
        images = torch.rand(S, IMG, IMG, 3, generator=g, device=dev)
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            batch_latents, cams, in_lat, in_cams, clip_v = model.prepare_batch(
                images, R, T, f, c, input_idx, target_idx)
            sync()
            t1 = time.perf_counter()
            res = ddim_sample(model, cams, in_lat, in_cams, clip_v, 2.5, num_steps=steps, generator=g)
            sync()
            t2 = time.perf_counter()
            imgs = model.decode_latents(res.latents[..., :4])
            sync()
            t3 = time.perf_counter()
        lat = res.latents
        log(f"  request {r}: prepare {t1 - t0:.3f}s, {steps} steps {t2 - t1:.3f}s "
            f"({(t2 - t1) / steps:.4f} s/step), decode {t3 - t2:.3f}s; max|latent| {lat.abs().max().item():.3f}, "
            f"image range [{imgs.min().item():.4f}, {imgs.max().item():.4f}]")
        check(tuple(batch_latents.shape) == (B, ls, ls, 5) and tuple(lat.shape) == (B, ls, ls, 5),
              f"latent shape {tuple(lat.shape)}")
        check(tuple(imgs.shape) == (B, IMG, IMG, 3), f"image shape {tuple(imgs.shape)}")
        check(bool(torch.isfinite(lat).all() and torch.isfinite(imgs).all()), "non-finite output")
        check(bool(imgs.min() >= 0 and imgs.max() <= 1), "images outside [0, 1]")
        step_s.append((t2 - t1) / steps)
        req_s.append(t3 - t0)
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
        "transformer_block": REQUESTS * steps * 16,
        "crossview": REQUESTS * steps,
        "crossview_two_phase": 0,
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    if profile:
        profile_steps(model, (cams, in_lat, in_cams, clip_v), profile)
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
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS sampling steps with torch.profiler")
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

    with Phase("build"):
        shutil.rmtree(_lib.BUILD_DIR, ignore_errors=True)
        info = _lib.build(force=True)
        _lib.lib()
        log(f"  one nvcc call, {info['seconds']:.2f}s -> {info['path']}")
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

    # launches of the phase that drives each kernel's path: the flagship
    # slice for K1-K4, the evaluation scene for the two-phase K4
    for name, r in rows.items():
        r["launches"] = (eval_counts if name == "crossview_two_phase" else counts).get(name, 0)
        r.pop("shape")
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
