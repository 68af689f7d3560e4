#!/usr/bin/env python3
"""Smoke test of mvdfusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--steps N] [--eval-steps N] [--forms-steps N] [--train-steps N] [--profile STEPS]
                          [--learn] [--loader]
    python3 chip_smoke.py --profile-only STEPS
    python3 chip_smoke.py --k1-sweep
    python3 chip_smoke.py --k5-sweep
    python3 chip_smoke.py --site-timers
    python3 chip_smoke.py --gn-timers
    python3 chip_smoke.py --tp-cards

--profile-only runs the device and build phases, reads K4 and K4b by stage
(device time per kernel, traced) and against their plain versions in bf16
ulps, answers one 1-step request to warm up, traces STEPS flagship steps
and STEPS steps of the evaluation scene (CFG batch 30) on the default route,
then STEPS flagship steps with the switched site forms on (K5, K6), and
stops (no checks, no JSON): it reads kernel names only, so the same script
profiles two trees of the port alike. --k1-sweep builds, then times
K1 at every shape of GN_STEP (CFG batches 16 and 30) on each cluster size
and two other thread counts, with the card's count of clusters held at
once, and logs CTA (0, 0)'s steps from K1's device clock stamps: the data
ops/groupnorm.py's plan cost model was fitted to. --k5-sweep builds, then
times K5 by phase (its block 0's clock stamps), and K6's attention with
one and two warpgroups a block beside the CUDA-core kernel. --site-timers
builds, then reads the K3, K5 and K6 sites and K6's attention at the
flagship's shapes with both timers (device_ms and time_ms); it calls only
entry points that two trees of the port share, so it compares them alike.
--gn-timers builds, then times K7's stats and apply passes and K8's
gn_fold_affine at the VAE's large maps by device_ms, each against its bound,
with entry points that older trees share (copy it into an unpacked parent
tree to compare two trees alike). --tp-cards builds, then takes one train
step at (dp=1, sp=2, tp=2) on four cards over NCCL, one rank a card,
against rank 0 alone, held to the tp phase's rules (a four-card machine).

Phases, each printed with elapsed seconds as it starts and ends:
  1. device   the card's name, count and power limit; exits non-zero
              without a CUDA device or without the package beside it
  2. build    removes any stale build directory, then builds every kernel
              (one nvcc process a source, all started together, then one
              link); prints its seconds and ptxas' registers, shared memory
              and spills per kernel
  3. kernels  each hand-written kernel against its plain PyTorch version at
              the shapes of the flagship and of the eval path in bf16 (and
              at small shapes in fp32), with the tolerance stated; times
              kernel, plain version and, where one exists, the one PyTorch
              call computing the same thing. K1 has a row at each (B, N, C,
              act) of the flagship step (B=16) and the eval step (B=30),
              GN_STEP, held to 1 bf16 ulp and a mean of 3e-4 x max|plain|,
              bit-equal on a second launch, timed beside F.group_norm; with
              the sums a step weighted by GN_STEP. The sites' LayerNorm has
              rows at (16384, 320), (4096, 640) and K6's (1024, 1280), timed
              beside F.layer_norm. K2 has three rows: CLIP, and
              its tile inside K3 at the 32^2 and 16^2 sites (the rows'
              launches: attention_site_n1024 and _n256, counted by K3's
              launcher). K5 is held bit for bit to a second launch and
              logged against K3 on the same inputs, by phase beside the
              standalone site GEMM at each product's shape, with its
              occupancy; K6's attention kernel has a row of its own (1 bf16
              ulp, bit-equal repeats) at N = 64, 128 and 256. K4's gather
              and its qkv tile with the view attention have rows of their
              own (the tile timed beside the standalone route: fp32 qkv
              GEMM + attention kernel). The site GEMM has one row at
              each distinct (M, N, K) of the three driven paths in bf16: the
              wgmma kernel (gemm_sm90.cu) against its plain version, timed
              beside block.cu's wmma tile and torch.matmul (cuBLAS)
  4. slice    the full-width model (random weights from a seed, built on the
              card) answers 2 requests: prepare_batch on a 256^2 scene,
              --steps eta=1 DDIM steps for 8 target views at CFG 2.5, decode;
              checks shapes, finiteness, the [0, 1] image range and that every
              kernel's launch count rose by what the path implies (every
              bf16 product on the wgmma GEMM, none on the wmma tile; K1's
              calls by shape as GN_STEP says)
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
  7. vae      the same model's VAE on three routes (VAE_ROUTES): the
              default (on the card the tiled GroupNorm K7 at every map
              above 2^20 elements an image, with MVDF_GN_TILED=1 as
              without), the default with the plain GroupNorm at those maps
              (the route before the card's repair), and with both of the
              reference's switched forms on (MVDF_GN_TILED=1 MVDF_CONV3X3=1:
              the fused GN + SiLU + conv K8 in the ResBlocks of maps of at
              least 64^2): the encode of the flagship's 9 images, the decode
              of 8 latents and the eval path's chunked decode of 15 views
              (chunks of 8 and 7); checks shapes, finiteness, the [0, 1]
              range and the launch counts, holds the default route against
              the plain GroupNorm's and the switched forms against the
              default, then times encode and decode per route
  8. weights  real weights at full width (run_weights): the slice phase's
              model written as a reference-layout file with the dead keys a
              real mvdfusion_sep23.pt carries (torch.save into the
              git-ignored build/), loaded by convert/reference.py's
              load_viewfusion into a second model from another seed after
              one flagship step filled its prepared-weight caches (0
              missing keys, unused = the dead keys, every parameter equal);
              both models answer the flagship request at 2 steps on the same
              noise, bit-equal (or within the source's run-to-run spread);
              a pre-surgery zero123 UNet file through load_zero123_unet
              (every other UNet row landed, the aligned_attn_* rows and the
              removed convs kept); one eta=0 request on quad timesteps (K1-K4
              launched, equal latents under other step noise); logs the
              file's GB and the write and load seconds, deletes the files
  9. scenes   the same model runs SCENES = 2 evaluation scenes (the eval
              phase's rig and protocol, random images from a numpy seed)
              through one eval_scenes pass for --eval-steps steps (GridAttn
              a scene a step, one UNet call a step over the CFG batch of
              60), then each scene alone with the same generators; holds
              the ground-truth fields bit-equal and the sampled ones in
              the mean to a tenth of the gap between the two scenes, one
              DDIM step of both ways to the forms phase's rule, naming
              the first UNet module that differs, and the batched step
              with the kernels against it under the kernel-off switch to
              the same rule; K1's calls at batch 60 held to GN_STEP (the
              kernels phase holds K1, the LayerNorm and the site GEMM at
              that batch against their plain versions); logs s/scene, kernel
              launches a scene and peak memory of both (with --profile,
              the profiler's launches a step of STEPS steps of each)
  10. loader  the native image loader (run_loader), where the host has the
              libjpeg, libpng and zlib headers (the device phase's probe
              logs g++, the headers and ldconfig's libraries), else only
              with --loader: builds native/loader.cc with g++ (a failed
              build fails the phase), writes a 2-scene Objaverse tree of
              the 16 fix_elevation views at 512^2 and reads it at 256^2
              through the native route and through PIL in turns, logging s
              a scene of each and the build's seconds; holds native
              against PIL at the stored size (pngs within 1e-6 x max(1,
              |x|), jpgs within 1/255 + 1e-6: the system libjpeg and
              Pillow's may round the inverse DCT apart)
  11. train   the train path (run_train): configs/train.yaml's model in
              bf16 with random weights, its trainer section (5 targets,
              4 scenes a call, grad_accum_step 4, finetune_unet) and its
              own `objaverse` dataset target with only the root moved to
              a 2-scene Objaverse-layout tree of random 256^2 renders
              (jpg, 16-bit depth png, jpg mask; 64 a scene) it writes (no
              render ships: the cut), through cli/train.py's main for
              --train-steps optimizer steps (the default step,
              train_fuse_mode "never") with a checkpoint, then a one-step
              resume; checks the frozen parameters bit-equal, K1 and K2
              launched inside the step, finite losses and gradients;
              prints s a call and an optimizer step, scenes/s, peak memory
              and the loader's route and s a scene and a batch against s a call;
              then one micro-step under "model"
              against "never" (TRAIN_MODE_* tolerances), one full-width
              apply_model_cfg with the kernels against MVDF_DISABLE_PALLAS=1
              (tools/numerics_check.py, no launch under the switch), and
              each autograd Function's input gradients at a train or
              flagship shape in bf16 against the plain version's autograd
              (bit-equal, or 1 bf16 ulp where its backward adds with
              atomics); with --profile, STEPS more calls by kernel
  12. dp      data parallelism (run_dp): one spawn of 2 ranks sharing the
              card over gloo (run_ranks, par_rank) serves this phase and
              the next, one configs/train.yaml model a rank (bf16,
              grad_accum_step 1, its weights drawn anew for each step).
              Rank 0 first runs alone what the ranks are held to; then
              the ranks take one optimizer step on 2 scenes, one scene
              each, the draws keyed on the scene's position; holds the
              loss, the gradient the optimizer read and the masters to
              rank 0's step alone with both scenes (DP_* tolerances) and
              the ranks to each other bit for bit; then one rank at world
              size 1 (NCCL: its init and an all-reduce on the card); logs
              each all-reduce's bytes and seconds, the step's seconds,
              peak memory a rank and rank 0's parts' seconds
  13. tp      tensor and view parallelism (run_tp): K4 and K4b at an sp
              rank's query count against their plain versions; from the
              dp phase's spawn: (a) the flagship model split at tp = 2
              answers a request on fixed noise (prepare, the sampler's
              first step, TP_STEPS steps), then the first step with the
              switched site forms (K5, K6 on gathered weights) and a
              decode with the fused conv (K8); (c) one train step at sp =
              2 and (b) one at tp = 2 (dp_step on a mesh), each against
              rank 0's run alone; holds (a) to TP_STEP_RTOL and
              TP_VAE_RTOL beside the noise scale of the kernels against
              the kernel-off switch, (b) and (c) to TP_LOSS_RTOL, each
              leaf's gradient to TP_LEAF_RTOL of its own max|g| and the
              masters to their AdamW gap, gather_params to the whole
              masters, the ranks bit-equal, and K1, K2, K3, K4, K7 (and
              K5, K6, K8 under the switches) launched on the split path;
              logs every reading before it holds one, each part's
              launches and gloo's all_gather on CUDA tensors (the port
              takes it; the phase fails without)
  14. learn   with --learn only (about 110 s, most of it the host's
              launches of 260 train steps): tests/test_learning.py's
              proof through tools/overfit_synthetic.py (run_learn): the
              tiny model in fp32, 2 synthetic scenes, 120 VAE steps, 260
              diffusion steps, 8-step DDIM of views 3 and 11; checks that
              test's four thresholds, K1 in the VAE pretrain and K1, K3
              and K4 in the trained evaluation, and one scene's trained
              evaluation against the kernel-off switch on the same noise
              (LEARN_PLAIN_RTOL)
  15. stages  K4 and K4b traced by kernel name (crossview_stages): device
              ms by stage and kernels a call (21 each, no copy from the
              host), and K1 (one kernel a call, read from a CUDA graph of
              its calls); last, since a profiler session slows the
              process's later launches on the host
The last three lines are the card's name and power limit, the kernels' JSON
record and {"ok": true, "device": ...}.
Comparisons run with TF32 off for matmuls and convolutions.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
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
# the VAE's launches at 256^2 by route (phase 7; PERF.md, Findings): on the
# card's default route the GroupNorms of larger maps take K7 (11 in the
# encoder, 19 in the decoder; ops/groupnorm.py::gn_route), with
# MVDF_GN_TILED=1 as without; with the plain GroupNorm there they launch
# nothing; with MVDF_CONV3X3=1 too, the ResBlocks at 64^2..256^2 (6 in the
# encoder, 9 in the decoder) take K8 (2 folds, 2 convs each) and the
# encoder's 64^2 x 256 norm1 (K1) goes with them; the decoder's 256^2
# norm_out stays on K7
VAE_LAUNCHES = {
    "default": {"encode": {"groupnorm": 11, "groupnorm_tiled": 11}, "decode": {"groupnorm": 11, "groupnorm_tiled": 19}},
    "plain_gn": {"encode": {"groupnorm": 11, "groupnorm_tiled": 0}, "decode": {"groupnorm": 11, "groupnorm_tiled": 0}},
    "both": {"encode": {"groupnorm": 10, "gn_fold_affine": 12, "conv3x3": 12},
             "decode": {"groupnorm": 11, "groupnorm_tiled": 1, "gn_fold_affine": 18, "conv3x3": 18}},
}
VAE_KERNELS = ("groupnorm", "groupnorm_tiled", "gn_fold_affine", "conv3x3", "attention")
EVAL_TARGETS = 15  # configs/gso.yaml inference.train_batch_size
SCENES = 2  # scenes of the scenes phase's one sampler pass
# the flagship UNet's transformer sites per apply_model_cfg: 8 at 32^2 (C=320),
# 8 at 16^2 (C=640), 8 at 8^2 (C=1280), 2 at the 4^2 middle (N=16, below
# every gate)
SITES_PER_LEVEL = 8
# K4's DiT layers (ViewFusionConfig.viewattn_layers)
DIT_LAYERS = 3
# site GEMMs per step: 6 at each of the 16 split sites (K3) + the DiT's 3 per
# layer (proj, fc1, fc2; its qkv product runs in the qkv + attention tile) +
# its output GEMM (K4); with the forms on, K5's 8 sites have none and K6's 8
# have 5 each
GEMMS_PER_STEP = 6 * 2 * SITES_PER_LEVEL + 3 * DIT_LAYERS + 1
GEMMS_PER_STEP_FORMS = 6 * SITES_PER_LEVEL + 5 * SITES_PER_LEVEL + 3 * DIT_LAYERS + 1
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


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time per call of `fn`: the calls are queued behind a sleep
    kernel that outlasts their queueing, so the two events bracket the
    device's work alone and not the host's launch path (time_ms measures
    whichever of the two is slower)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3  # queueing + device, an upper bound of the queueing
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1 << 20)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = (1 << 20) / max(a.elapsed_time(b), 1e-3)
    torch.cuda._sleep(int(2 * host_ms * cycles_per_ms) + 1)
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


def compare_ulp(name, got, want, why: str, mean_tol: float | None = None) -> float:
    """bf16: |kernel - plain| <= 1 bf16 ulp of max|plain| (each side rounds
    its fp32 result once; the fp32 results differ by far less than an ulp),
    and with `mean_tol` the mean |kernel - plain| <= mean_tol x max|plain|."""
    diff = (got.float() - want.float()).abs()
    err, mean = diff.max().item(), diff.mean().item()
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    ok = math.isfinite(err) and err <= ulp and (mean_tol is None or mean <= mean_tol * top)
    mean_txt = "" if mean_tol is None else f", mean {mean:.3e} against {mean_tol:g} x max|plain| = {mean_tol * top:.3e}"
    log(f"  {name} [bf16]: max|kernel - plain| = {err:.3e}, tolerance 1 bf16 ulp of max|plain| {top:.3e} = "
        f"{ulp:.3e}{mean_txt} ({why}) -> {'ok' if ok else 'MISS'}")
    check(ok, f"{name}: kernel disagrees with its plain version ({err:.3e})")
    return err


def bf16_ulp(t):
    """The bf16 ulp of each element of `t` (that of 2^-126 at zero)."""
    return (t.abs().clamp_min(2.0**-126).log2().floor() - 7).exp2()


def compare_geglu(name, got, want, a, w, bias) -> float:
    """bf16 GEGLU with `steps` (gemm_plain: out = r(r(val) * r(r(g/2) *
    r(1 + erf(g/sqrt 2)))), g = r(g), r a bf16 rounding): both sides round
    the same fp32 sums, which differ by far less than an ulp, so each of
    those roundings may go the other way once; an element's allowance is
    what that does through the chain: for a = r(val) and f the gelu factor,
    ulp(a)|f| + |a| df + ulp(a) df + ulp(out), with df the factor's own
    (g's ulp through g/2 and the erf, e's and f's ulps). Held to the larger
    of that and 1 bf16 ulp of max|plain|, and a mean of 1e-4 x max|plain|.
    Logs the element nearest its allowance and the one farthest from the
    plain value in ulps of max|plain|, each with its factors."""
    import torch

    from mvdfusion_tpu_torch.ops import block as K3

    v = a.float() @ w.float().t() + bias.float()
    M, N = v.shape
    v = v.reshape(M, N // (2 * K3._GEGLU_HALF), 2, K3._GEGLU_HALF)
    r = lambda t: t.to(torch.bfloat16).float()
    val, g = r(v[:, :, 0].reshape(M, N // 2)), r(v[:, :, 1].reshape(M, N // 2))
    h, e = r(g * 0.5), r(1.0 + torch.erf(g * K3._SQRT_HALF))
    f = r(h * e)
    du_g = bf16_ulp(g)
    d_e = 0.7979 * torch.exp(-0.5 * g * g) * du_g + bf16_ulp(e)  # d erf(g/sqrt 2)/dg <= sqrt(2/pi)
    d_f = 0.5 * du_g * e.abs() + h.abs() * d_e + 0.5 * du_g * d_e + bf16_ulp(f)
    d_a = bf16_ulp(val)
    top = want.float().abs().max().item()
    ulp_top = 2.0 ** (math.floor(math.log2(top)) - 7)
    allow = (d_a * f.abs() + val.abs() * d_f + d_a * d_f + bf16_ulp(want.float())).clamp_min(ulp_top)
    diff = (got.float() - want.float()).abs()
    ratio = diff / allow
    mean = diff.mean().item()
    ok = math.isfinite(diff.max().item()) and ratio.max().item() <= 1.0 and mean <= 1e-4 * top
    for what, i in (("nearest its allowance", int(ratio.argmax())), ("largest |diff|", int(diff.argmax()))):
        at = lambda t: t.flatten()[i].item()
        log(f"  {name} [bf16] element {what}: |diff| {at(diff):.3e} = {at(diff) / ulp_top:.2f} ulp of max|plain| "
            f"{top:.3e}, allowance {at(allow):.3e}; plain {at(want):.4e}, kernel {at(got):.4e}, a = r(val) "
            f"{at(val):.4e}, g {at(g):.4e}, gelu factor {at(f):.4e}")
    log(f"  {name} [bf16]: max|diff| / allowance {ratio.max().item():.3f}, {(diff > ulp_top).sum().item()} elements "
        f"over 1 ulp of max|plain|, mean {mean:.3e} against 1e-4 x max|plain| = {1e-4 * top:.3e} (each rounding "
        f"of the GEGLU chain may go the other way once) -> {'ok' if ok else 'MISS'}")
    check(ok, f"{name}: kernel disagrees with its plain version ({ratio.max().item():.3f} of the allowance)")
    return diff.max().item()


def compare_qkv_attention(name, got, want, ln1, qkv_w, heads: int) -> float:
    """bf16 K6 attention (qkv_attention_plain: q, k, v = r(ln1 W^T); l = q
    k^T in fp32; p = r(softmax(scale l)); out = r(p v), r a bf16
    rounding), the kernel rounding at the same points: both sides round the
    same fp32 sums, which differ by far less than an ulp, so a rounding
    goes the other way rarely and on its own. Each sum of the chain is
    taken root-sum-square over its terms (at least its largest, the one a
    lone flip moves): with dq, dk, dv the ulps of q, k, v, a logit moves by
    dL = rss over the head's dims of dq |k|, |q| dk, dq dk; a probability
    by dp = p scale rss(dL, p_m dL_m over the keys) + ulp(p); the output
    by rss over the keys of dp_k (|v_k| + dv_k) and p_k dv_k, plus
    ulp(out). Held to the larger of that and 1 bf16 ulp of max|plain|, and
    a mean of 1e-4 x max|plain|. Logs the element nearest its allowance."""
    import torch

    B, N, C = ln1.shape
    dh = C // heads
    r = lambda t: t.to(torch.bfloat16).float()
    qkv = r(ln1.float() @ qkv_w.float().t()).reshape(B, N, 3, heads, dh).permute(2, 0, 3, 1, 4)  # (3, B, h, N, dh)
    q, k, v = qkv[0], qkv[1], qkv[2]
    dq, dk, dv = bf16_ulp(q), bf16_ulp(k), bf16_ulp(v)
    scale = dh**-0.5
    p_un = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    sq = lambda t: (t * t).transpose(-1, -2)
    dL = ((dq * dq) @ sq(k) + (q * q) @ sq(dk) + (dq * dq) @ sq(dk)).sqrt()
    p = r(p_un)
    dp = p_un * scale * (dL * dL + (p_un * dL).square().sum(-1, keepdim=True)).sqrt() + bf16_ulp(p)
    out = r(p @ v)
    allow = ((dp * dp) @ (v.abs() + dv).square() + (p * p) @ (dv * dv)).sqrt() + bf16_ulp(out)  # (B, h, N, dh)
    allow = allow.permute(0, 2, 1, 3).reshape(B, N, C)
    top = want.float().abs().max().item()
    ulp_top = 2.0 ** (math.floor(math.log2(top)) - 7)
    allow = allow.clamp_min(ulp_top)
    diff = (got.float() - want.float()).abs()
    ratio = diff / allow
    mean = diff.mean().item()
    ok = math.isfinite(diff.max().item()) and ratio.max().item() <= 1.0 and mean <= 1e-4 * top
    i = int(ratio.argmax())
    at = lambda t: t.flatten()[i].item()
    log(f"  {name} [bf16]: max|diff| / allowance {ratio.max().item():.3f} (|diff| {at(diff):.3e}, allowance "
        f"{at(allow):.3e} = {at(allow) / ulp_top:.2f} ulp of max|plain|, plain {at(want):.4e}); max|diff| "
        f"{diff.max().item():.3e} = {diff.max().item() / ulp_top:.2f} ulp of max|plain| {top:.3e}, "
        f"{(diff > ulp_top).sum().item()} elements over 1 ulp; mean {mean:.3e} against 1e-4 x max|plain| = "
        f"{1e-4 * top:.3e} (a rounding of q, k, v, p or the output may go the other way) -> {'ok' if ok else 'MISS'}")
    check(ok, f"{name}: kernel disagrees with its plain version ({ratio.max().item():.3f} of the allowance)")
    return diff.max().item()


def compare_tokens(name, got, want, bound) -> float:
    """Phase-1 tokens, bf16: |kernel - plain| <= 1 bf16 ulp of the larger
    token (each side rounds its fp32 sum once) + `bound`, the fp32 sums'
    own difference (crossview.gather_tokens_bound). Logs the element that
    comes closest with its parts; returns the largest |diff| in bf16 ulps."""
    got, want = got.float(), want.float()
    mag = got.abs().maximum(want.abs())
    ulp = bf16_ulp(mag)
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


K6_SEEDS = (1, 2, 3, 4, 5, 6, 7, 8)  # the (30, 64, 1280) attention row's extra inputs, each from its own generator


def big_attention_seeds() -> None:
    """K6's attention at the eval step's (30, 64, 1280), 8 heads, bf16, on
    K6_SEEDS: inputs from a generator of their own (the kernels phase's
    generator, and so every later row's inputs, stay as they are), each
    held to compare_qkv_attention."""
    import torch

    from mvdfusion_tpu_torch.ops import block as K3

    bf = torch.bfloat16
    B, N, C, heads = 30, 64, 1280, 8
    for seed in K6_SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        ln1 = torch.randn(B, N, C, generator=g, device="cuda").to(bf)
        qkv_w = (torch.randn(3 * C, C, generator=g, device="cuda") * C**-0.5).to(bf)
        compare_qkv_attention(f"big attention B={B} N={N} C={C} heads={heads} seed {seed}",
                              K3.launch_big_attention(ln1, qkv_w, heads), K3.qkv_attention_plain(ln1, qkv_w, heads),
                              ln1, qkv_w, heads)


def site_inputs(rnd, B, N, C, dt, a2_map):
    """A transformer site's x, attn2 term (a (B, C) row or a (B, N, C) map)
    and weights, GEGLU inner width 4C, drawn from `rnd`."""
    from mvdfusion_tpu_torch.ops import block as K3

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

    rows.update(groupnorm_checks(rnd))
    rows.update(layernorm_checks(rnd))

    # K2 attention. bf16 at dh <= 128 takes the tensor-core tile, held to 1
    # bf16 ulp: CLIP (ragged N=257, dh=64, the pv form) and the self-attention
    # inside K3 at the 32^2 (dh=40) and 16^2 (dh=80) sites (the probs form),
    # on strided views of one packed qkv buffer as K3 passes them (timed).
    # The fp32 loop: fp32 operands, and the VAE mid-attention's dh=512.
    log(" K2 attention")
    for dt, (B, N, H, dh) in ((torch.float32, (2, 77, 3, 40)), (torch.float32, (1, 130, 1, 512)),
                              (bf, (1, 1024, 1, 512))):
        q, k, v = (rnd(B, N, H, dh, dt=dt) for _ in range(3))
        compare(f"attention {(B, N, H, dh)}", K2.launch_attention(q, k, v, dh**-0.5),
                K2.attention_plain(q, k, v, dh**-0.5), 2e-2 if dt == bf else 1e-4,
                "the fp32 loop keeps the probabilities in fp32, the plain version rounds them" if dt == bf
                else "fp32 online vs two-pass softmax", dt)
    for name, (B, N, H, dh), mode, what in (
        ("attention_site_n1024", (16, 1024, 8, 40), K2.MODE_PROBS, "32^2 site"),
        ("attention_site_n256", (16, 256, 8, 80), K2.MODE_PROBS, "16^2 site"),
        ("attention", (1, 257, 16, 64), K2.attention_mode(64), "CLIP"),
    ):
        qkv = rnd(B, N, 3, H, dh, dt=bf)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        form = "pv" if mode == K2.MODE_PV else "probs"
        err = compare_ulp(f"attention {what} {(B, N, H, dh)} ({form})", K2.launch_attention(q, k, v, dh**-0.5, mode),
                          K2.attention_plain(q, k, v, dh**-0.5, mode),
                          f"both round P and the output where the reference's {form} form rounds", mean_tol=1e-4)
        ms = time_ms(lambda: K2.launch_attention(q, k, v, dh**-0.5, mode), ITERS)
        plain_ms = time_ms(lambda: K2.attention_plain(q, k, v, dh**-0.5, mode), ITERS)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=dh**-0.5), ITERS)
        flops = 4 * B * H * N * N * dh
        bms, by = bound(flops, nbytes(q, k, v, q))
        log(f"  {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s; SDPA {lib_ms:.4f} ms")
        rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/attention.cu (attention.cuh)",
                          replaces="mvdfusion_tpu/ops/attention.py:172", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=lib_ms,
                          shape=f"q/k/v ({B}, {N}, {H}, {dh}) bf16 ({what}, {form}), views of one packed qkv")

    # K3 transformer site: 32^2 C=320 (row attn2) and 16^2 C=640 (attn2 map)
    # at the eval path's CFG batch 30 and the flagship's 16 (timed)
    log(" K3 transformer_block")

    site = lambda B, N, C, dt, a2_map: site_inputs(rnd, B, N, C, dt, a2_map)

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
                      rtol, "bf16 rounding at the same points, fp32 sums in another order" if dt == bf
                      else "fp32 sum order", dt)
    wp = K3.prepare_site_weights(w, dt)  # as the model's sites hold them
    ms = time_ms(lambda: K3.launch_transformer_block(x, a2, wp, heads), ITERS)
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
    # path's CFG batch 30 and the flagship's 16 (timed); in bf16 its products
    # are wgmma over TMA rings. Its row logs each phase by block 0's clock
    # beside the standalone site GEMM (gemm_sm90) at that phase's (M, N, K)
    # and epilogue, and K5 against K3 on the same inputs in the same run.
    log(" K5 transformer_block_single")
    for dt, (B, N, C, heads, a2_map), rtol in (
        (torch.float32, (2, 128, 64, 4, False), 1e-4),
        (torch.float32, (2, 128, 64, 8, True), 1e-4),
        (bf, (30, 1024, 320, 8, False), 3e-2),
        (bf, (16, 1024, 320, 8, True), 3e-2),
        (bf, (16, 1024, 320, 8, False), 3e-2),
    ):
        x, a2, w = site(B, N, C, dt, a2_map)
        got = K3.launch_transformer_block_single(x, a2, w, heads)
        err = compare(f"transformer_block_single B={B} N={N} C={C} a2={'map' if a2_map else 'row'}",
                      got, K3.transformer_block_plain(x, a2, w, heads),
                      rtol, "bf16 rounding at the same points, fp32 sums in another order" if dt == bf
                      else "fp32 sum order", dt)
        check(torch.equal(got, K3.launch_transformer_block_single(x, a2, w, heads)),
              "transformer_block_single: two launches differ")
    wp = K3.prepare_site_weights(w, dt)
    ms = device_ms(lambda: K3.launch_transformer_block_single(x, a2, wp, heads), ITERS)
    split_ms = device_ms(lambda: K3.launch_transformer_block(x, a2, wp, heads), ITERS)
    plain_ms = time_ms(lambda: K3.transformer_block_plain(x, a2, w, heads), ITERS)
    bms, by = bound(site_flops(B, N, C), 2 * nbytes(x) + nbytes(a2) + nbytes(*w))
    compare_ulp(f"transformer_block_single B={B} N={N} C={C} against K3 on the same inputs",
                K3.launch_transformer_block_single(x, a2, wp, heads), K3.launch_transformer_block(x, a2, wp, heads),
                "the same products, epilogues and rounding points; fp32 sums in another order", mean_tol=3e-4)
    K3.launch_transformer_block_single(x, a2, wp, heads)
    phases = K3.site_phase_ms(x, 4 * C)
    blocks, sms = K3.site_grid_blocks(x, 4 * C), torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  transformer_block_single: one launch {ms:.4f} ms, the split form's nine launches {split_ms:.4f} ms "
        f"at the same shape (device time); by phase (block 0's clock): "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items()))
    for ph in K3.site_gemm_phases(B, N, C, 4 * C):
        a_, w_ = rnd(ph.M, ph.K, dt=bf), getattr(wp, ph.w)
        kw = dict(bias=None if ph.bias is None else getattr(wp, ph.bias))
        if ph.kind == "geglu":
            kw.update(act=K3.ACT_GEGLU, steps=True)
        elif ph.kind in ("res1", "res2"):
            kw.update(res1=rnd(ph.M, ph.N, dt=bf), steps=True)
            if ph.kind == "res2":
                kw.update(res2=a2, res2_div=N)
        alone = device_ms(lambda: K3.gemm(a_, w_, **kw), ITERS)
        log(f"  transformer_block_single phase {ph.name} ({ph.M}, {ph.N}, {ph.K}): {phases[ph.name]:.4f} ms, the "
            f"standalone site GEMM {alone:.4f} ms ({phases[ph.name] / alone:.2f}x)")
    log(f"  transformer_block_single: occupancy {blocks} blocks of 128 threads = {blocks / sms:g} an SM over {sms} SMs")
    log(f"  transformer_block_single: {ms / split_ms:.2f}x K3's time (PERF.md: the target is at most 1x)")
    rows["transformer_block_single"] = dict(
        name="transformer_block_single", route="cuda",
        source="mvdfusion_tpu_torch/csrc/blockforms.cu (site_kernel; gemm.cuh, attention.cuh)",
        replaces="mvdfusion_tpu/ops/block.py:298", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="x (16, 1024, 320) bf16, 8 heads, attn2 row")

    # K6's attention kernel alone: the tensor-core tile at the C=1280 8^2
    # sites (N=64) and at N=128, the CUDA-core kernel at the 512^2 stretch's
    # N=256, held to 1 bf16 ulp, a mean of 1e-4 x max|plain| and bit-equal
    # repeats; timed at the flagship's (16, 64, 1280)
    log(" K6 attention (big_attention)")
    for B, N in ((30, 64), (3, 128), (2, 256), (16, 64)):
        C, heads = 1280, 8
        ln1, qkv_w = rnd(B, N, C, dt=bf), rnd(3 * C, C, std=C**-0.5, dt=bf)
        got = K3.launch_big_attention(ln1, qkv_w, heads)
        attn_err = compare_qkv_attention(f"big attention B={B} N={N} C={C} heads={heads} "
                                         f"({K3.big_attention_route(bf, N, C, heads)})", got,
                                         K3.qkv_attention_plain(ln1, qkv_w, heads), ln1, qkv_w, heads)
        check(torch.equal(got, K3.launch_big_attention(ln1, qkv_w, heads)), "big attention: two launches differ")
    big_attention_seeds()
    attn_ms = device_ms(lambda: K3.launch_big_attention(ln1, qkv_w, heads), ITERS)
    attn_plain_ms = time_ms(lambda: K3.qkv_attention_plain(ln1, qkv_w, heads), ITERS)
    abms, aby = bound(2 * B * N * C * 3 * C + 4 * B * N * N * C, nbytes(ln1, qkv_w, ln1))
    log(f"  big_attention: {attn_ms:.4f} ms, {(2 * B * N * C * 3 * C + 4 * B * N * N * C) / attn_ms / 1e9:.1f} "
        f"TFLOP/s, bound {abms:.4f} ms ({aby})")
    rows["big_attention"] = dict(
        name="big_attention", route="cuda", source="mvdfusion_tpu_torch/csrc/blockforms.cu (bigattn_sm90_kernel)",
        replaces="mvdfusion_tpu/ops/block.py:370", max_abs_err=attn_err, ms=attn_ms, plain_ms=attn_plain_ms,
        bound_ms=abms, bound_by=aby, library_ms=None, shape="ln1 (16, 64, 1280) bf16, qkv_w (3840, 1280), 8 heads")

    # K6 big-C site: the C=1280 8^2 sites at CFG batch 30 (attn2 map) and 16
    # (timed), and the 512^2 stretch's C=1280 16^2 sites (N=256); the
    # attention kernel alone on each site's weights first
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
        compare(f"big attention B={B} N={N} C={C} heads={heads}", K3.launch_big_attention(ln1, w.qkv_w, heads),
                K3.qkv_attention_plain(ln1, w.qkv_w, heads), rtol,
                "q, k, v and the probabilities rounded at the same points, fp32 sums in another order", dt)
        err = compare(f"transformer_block_big B={B} N={N} C={C} a2={'map' if a2_map else 'row'}",
                      K3.launch_transformer_block_big(x, a2, w, heads), K3.transformer_block_big_plain(x, a2, w, heads),
                      rtol, "bf16 rounding at the same points, fp32 sums in another order" if dt == bf
                      else "fp32 sum order", dt)
    wp = K3.prepare_site_weights(w, dt)
    ms = device_ms(lambda: K3.launch_transformer_block_big(x, a2, wp, heads), ITERS)
    plain_ms = time_ms(lambda: K3.transformer_block_big_plain(x, a2, w, heads), ITERS)
    bms, by = bound(site_flops(B, N, C), 2 * nbytes(x) + nbytes(a2) + nbytes(*w))
    log(f"  transformer_block_big: the attention kernel (projections + attention) {attn_ms:.4f} ms of {ms:.4f} ms")
    rows["transformer_block_big"] = dict(
        name="transformer_block_big", route="cuda",
        source="mvdfusion_tpu_torch/csrc/blockforms.cu (bigattn_sm90_kernel) + gemm_sm90.cu + block.cu + groupnorm.cu",
        replaces="mvdfusion_tpu/ops/block.py:370", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, shape="x (16, 64, 1280) bf16, 8 heads, attn2 row")

    rows.update(crossview_checks(rnd, dev))
    rows.update(vae_kernel_checks(rnd))
    rows.update(gemm_checks(rnd))
    # K1 and the LayerNorm at the scenes phase's CFG batch of 60 (the GEMM's
    # rows at that batch are GEMM_ROWS' last), after every other row: the
    # rows above keep the inputs they had before these were added
    rows.update(groupnorm_checks(rnd, ("scenes",)))
    rows.update(layernorm_checks(rnd, ("scenes",)))
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms at {r['shape']}")
    return rows


# K1's calls in one UNet step at CFG batch 2B, by (N, C, act) (nn/unet.py):
# the 22 ResBlocks' two GroupNorms (SiLU, eps 1e-5) over their input and
# output channels, norm_out, and the 26 sites' norms (none, eps 1e-6): 16
# inside K3 (32^2 and 16^2), 8 at 8^2 and 2 at the 4^2 middle on the module
# path. 71 calls, 55 of them counted under "groupnorm". The slice and eval
# phases hold _lib.GN_SHAPES to this table.
GN_STEP = {
    (1024, 320, "silu"): 8, (1024, 320, "none"): 8, (1024, 640, "silu"): 2, (1024, 960, "silu"): 1,
    (256, 320, "silu"): 1, (256, 640, "silu"): 6, (256, 640, "none"): 8, (256, 960, "silu"): 1,
    (256, 1280, "silu"): 1, (256, 1920, "silu"): 1,
    (64, 640, "silu"): 1, (64, 1280, "silu"): 6, (64, 1280, "none"): 8, (64, 1920, "silu"): 1,
    (64, 2560, "silu"): 2,
    (16, 1280, "silu"): 11, (16, 1280, "none"): 2, (16, 2560, "silu"): 3,
}
GN_EPS = {"silu": 1e-5, "none": 1e-6}
GN_BATCH = {"slice": 16, "eval": 2 * EVAL_TARGETS, "scenes": 2 * SCENES * EVAL_TARGETS}  # the UNet's CFG batch on each path
GN_PATH = {"slice": "flagship", "eval": "eval", "scenes": f"{SCENES}-scene eval"}


def gn_inputs(rnd, B, N, C, dt):
    return rnd(B, N, C, dt=dt) * 3 + 1, 1 + rnd(C, std=0.1), rnd(C, std=0.1)


def groupnorm_checks(rnd, phases=("slice", "eval")):
    """K1 against its plain version: fp32 at a small shape (1e-4 x max(1,
    max|plain|)); bf16 at every (B, N, C, act) of the flagship step (B=16)
    the eval step (B=30) and the scenes phase's step (B=60), 1 bf16 ulp of max|plain| and a mean of 3e-4 x
    max|plain|, a second launch bit-equal; each timed in device time beside
    F.group_norm and the plain version. Logs K1's device ms a step: the rows'
    times weighted by GN_STEP. `phases`: the GN_BATCH entries to check (the
    fp32 case and the summary row come with "slice")."""
    import torch
    import torch.nn.functional as F

    from mvdfusion_tpu_torch.ops import groupnorm as K1

    bf = torch.bfloat16
    rows, per_step = {}, {}
    log(" K1 groupnorm")
    if "slice" in phases:
        x, w, b = gn_inputs(rnd, 2, 64, 96, torch.float32)
        for act, eps in GN_EPS.items():
            compare(f"groupnorm (2, 64, 96) act={act} eps={eps}", K1.launch_group_norm(x, w, b, 32, eps, act),
                    K1.group_norm_plain(x, w, b, 32, eps, act), 1e-4, "fp32 sum order", torch.float32)
    for phase in phases:
        B = GN_BATCH[phase]
        total = 0.0
        for (N, C, act), n in GN_STEP.items():
            x, w, b = gn_inputs(rnd, B, N, C, bf)
            eps = GN_EPS[act]
            run = lambda: K1.launch_group_norm(x, w, b, 32, eps, act)
            name = f"groupnorm {B}x{N}x{C} {act}"
            got = run()
            err = compare_ulp(name, got, K1.group_norm_plain(x, w, b, 32, eps, act),
                              "fp32 statistics on both sides, sums in another order; one bf16 rounding",
                              mean_tol=3e-4)
            check(torch.equal(got, run()), f"{name}: two runs differ")
            ms = device_ms(run, ITERS)
            host_ms = time_ms(run, ITERS)
            plain_ms = device_ms(lambda: K1.group_norm_plain(x, w, b, 32, eps, act), max(2, ITERS // 4))
            lib_ms = device_ms(lambda: F.group_norm(x.transpose(1, 2), 32, w.to(bf), b.to(bf), eps), ITERS)
            bms, by = bound(10 * x.numel(), 2 * nbytes(x) + nbytes(w, b))
            plan = K1.card_plan(B, N, C, bf)
            total += n * ms
            log(f"  {name}: {ms:.4f} ms, F.group_norm {lib_ms:.4f}, bound {bms:.4f} ({bms / ms * 100:.0f}%), "
                f"{n} a step; back-to-back calls from the host {host_ms:.4f} ms a call; plan k={plan.k} "
                f"rows={plan.rows} threads={plan.threads} smem={plan.smem}")
            rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/groupnorm.cu",
                              replaces="mvdfusion_tpu/ops/groupnorm.py:54", max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms, per_step=n,
                              host_ms=host_ms,
                              shape=f"x ({B}, {N}, {C}) bf16, 32 groups, eps {eps}, act {act}",
                              phase=phase, launch_key=(B, N, C, act))
        per_step[phase] = total
        log(f"  K1 a {GN_PATH[phase]} step (CFG batch {B}): {total:.4f} ms in "
            f"{sum(GN_STEP.values())} calls")
    if "slice" not in phases:
        return rows
    r = dict(rows["groupnorm 16x1024x320 none"], name="groupnorm")
    for key in ("phase", "launch_key", "per_step", "host_ms"):
        r.pop(key)
    r["step_ms"] = per_step
    return {"groupnorm": r, **rows}


# the sites' LayerNorm: LN1 and LN3 of the 16 split sites a step at 32^2
# (16 x 1024 rows of C=320) and 16^2 (16 x 256 of C=640), and of the forms
# route's 8 big-C sites (16 x 64 of C=1280); the scenes phase's CFG batch of
# 60 at 32^2 and 16^2
_B60 = GN_BATCH["scenes"]
LN_ROWS = ((16384, 320, "slice"), (4096, 640, "slice"), (1024, 1280, "forms"), (_B60 * 1024, 320, "scenes"),
           (_B60 * 256, 640, "scenes"))
LN_PER_STEP = 2 * SITES_PER_LEVEL


def layernorm_checks(rnd, phases=("slice", "forms")):
    """block.cu's LayerNorm against _ln_plain at the sites' widths in bf16:
    rows at the residual stream's scale (mean 4, std 1) and constant rows,
    1 bf16 ulp of max|plain| and a mean of 3e-4 x max|plain|, a second launch
    bit-equal; timed in device time beside F.layer_norm. `phases`: the
    LN_ROWS to check, by their phase."""
    import torch
    import torch.nn.functional as F

    from mvdfusion_tpu_torch.ops import block as K3

    bf = torch.bfloat16
    rows, total = {}, 0.0
    log(" K3 layernorm")
    for M, C, phase in (r for r in LN_ROWS if r[2] in phases):
        x = torch.cat([rnd(M - 8, C) + 4, torch.full((8, C), 2.5, device="cuda")]).to(bf)
        w, b = 1 + rnd(C, std=0.1), rnd(C, std=0.1)
        name = f"layernorm {M}x{C}"
        got = K3.layernorm(x, w, b)
        err = compare_ulp(name, got, K3._ln_plain(x, w, b), "E[x^2] - mean^2 in fp32 on both sides, sums in "
                          "another order; one bf16 rounding", mean_tol=3e-4)
        check(torch.equal(got, K3.layernorm(x, w, b)), f"{name}: two runs differ")
        ms = device_ms(lambda: K3.layernorm(x, w, b), ITERS)
        host_ms = time_ms(lambda: K3.layernorm(x, w, b), ITERS)
        plain_ms = device_ms(lambda: K3._ln_plain(x, w, b), max(2, ITERS // 4))
        lib_ms = device_ms(lambda: F.layer_norm(x, (C,), w.to(bf), b.to(bf), 1e-5), ITERS)
        bms, by = bound(8 * x.numel(), 2 * nbytes(x) + nbytes(w, b))
        if phase == "slice":
            total += LN_PER_STEP * ms
        log(f"  {name}: {ms:.4f} ms, F.layer_norm {lib_ms:.4f}, bound {bms:.4f} ({bms / ms * 100:.0f}%); "
            f"back-to-back calls from the host {host_ms:.4f} ms a call")
        rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/block.cu (gemm.cuh::ln_row)",
                          replaces="mvdfusion_tpu/ops/block.py:315" if C < 1280 else "mvdfusion_tpu/ops/block.py:338",
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                          shape=f"x ({M}, {C}) bf16, mean 4 std 1, 8 constant rows", phase=phase,
                          launch_key=(M, C))
    if "slice" in phases:
        log(f"  the sites' LayerNorm a flagship step: {total:.4f} ms in {2 * LN_PER_STEP} calls")
    return rows


def k1_sweep() -> None:
    """K1 at every shape of GN_STEP at CFG batches 16 and 30 in bf16, on each
    cluster size k the card schedules: device ms and the gap to the plain
    version (1 bf16 ulp of max|plain| held), the plan's own k marked."""
    import torch

    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.ops import groupnorm as K1

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s, std=1.0, dt=torch.float32: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    bf = torch.bfloat16
    for B in GN_BATCH.values():
        for N, C in dict.fromkeys((N, C) for N, C, _ in GN_STEP):
            x, w, b = gn_inputs(rnd, B, N, C, bf)
            want = K1.group_norm_plain(x, w, b, 32, 1e-5, "silu")
            chosen = K1.card_plan(B, N, C, bf).k
            cells = []
            for k in (1, 2, 4, 8, 16):
                plan = K1.plan_group_norm(B, N, C, bf, k=k)
                held = _lib.gn_max_clusters(plan.k, plan.threads, plan.smem, plan.resident, 1)
                if held < 1:
                    cells.append(f"k={k} not schedulable")
                    continue
                run = lambda plan=plan, act="silu": K1.launch_group_norm(x, w, b, 32, 1e-5, act, plan=plan)
                compare_ulp(f"groupnorm {B}x{N}x{C} k={k}", run(), want, "the sweep", mean_tol=3e-4)
                cells.append(f"k={k}{'*' if k == chosen else ''} {device_ms(run, ITERS):.4f}"
                             f"{'' if plan.resident else ' (re-read)'} [{held} clusters at once]")
                if k == chosen:
                    cells.append(f"act none {device_ms(lambda: run(act='none'), ITERS):.4f}")
                    for target in (128, 512):  # other thread counts at this k
                        other = K1.plan_group_norm(B, N, C, bf, k=k, threads=target)
                        if other.threads != plan.threads:
                            cells.append(f"{other.threads} threads {device_ms(lambda: run(plan=other), ITERS):.4f}")
            log(f"  k1 sweep {B}x{N}x{C}: " + ", ".join(cells))
    # where a call's time goes: a trivial PyTorch kernel's device_ms as the
    # launch floor, then CTA (0, 0)'s steps from K1's clock stamps
    tiny = torch.zeros(256, device=dev)
    log(f"  k1 sweep: a trivial kernel (256-element add) {device_ms(lambda: tiny.add_(1.0), ITERS):.4f} ms a call")
    for B, N, C in ((16, 1024, 320), (30, 1024, 320), (16, 1024, 960), (16, 256, 640), (16, 64, 1280),
                    (16, 16, 1280)):
        x, w, b = gn_inputs(rnd, B, N, C, bf)
        plan = K1.card_plan(B, N, C, bf)
        stamps = torch.zeros(8 + 2 * B * plan.k, dtype=torch.int64, device=dev)
        for _ in range(3):
            K1.launch_group_norm(x, w, b, 32, 1e-5, "silu", stamps=stamps)
        t = stamps.tolist()
        ctas = t[8:]
        starts, ends = ctas[0::2], ctas[1::2]
        log(f"  k1 sweep {B}x{N}x{C} silu, {plan}: CTA (0, 0) by step (us) "
            + ", ".join(f"{name} {(t[i + 1] - t[i]) / 1e3:.2f}" for i, name in enumerate(K1.K1_PHASES))
            + f"; CTAs start over {(max(starts) - min(starts)) / 1e3:.2f} us, end over "
            f"{(max(ends) - min(ends)) / 1e3:.2f} us, first start to last end {(max(ends) - min(starts)) / 1e3:.2f} us")


def k5_sweep() -> None:
    """K5 at the flagship's 32^2 site (16, 1024, 320) in bf16 by phase (its
    block 0's clock stamps), then K6's attention at the flagship's and the
    eval path's CFG batch (16, 30) with one and two warpgroups a block and
    on the CUDA-core kernel: the data of the choice big_attention_consumers
    makes (device time, device_ms)."""
    import torch

    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.ops import block as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s, std=1.0, dt=torch.float32: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    bf = torch.bfloat16
    B, N, C, heads = 16, 1024, 320, 8
    x, a2, w = site_inputs(rnd, B, N, C, bf, False)
    w = K3.prepare_site_weights(w, bf)
    run = lambda: K3.launch_transformer_block_single(x, a2, w, heads)
    ms = device_ms(run, ITERS)
    run()
    log(f"  K5: {ms:.4f} ms, {K3.site_grid_blocks(x, 4 * C)} blocks; by phase: "
        + ", ".join(f"{k} {v:.4f}" for k, v in K3.site_phase_ms(x, 4 * C).items()))
    for B in (16, 30):
        ln1, qkv_w = rnd(B, 64, 1280, dt=bf), rnd(3 * 1280, 1280, std=1280**-0.5, dt=bf)
        out = torch.empty_like(ln1)
        cores = lambda: _lib.call("mvdf_big_attention", ln1, qkv_w, None, out, B, 64, 1280, 8, 160**-0.5, 1, 0)
        times = {cons: device_ms(lambda: K3.launch_big_attention(ln1, qkv_w, 8, cons), ITERS) for cons in (1, 2)}
        log(f"  K6 attention B={B} N=64: one warpgroup a block {times[1]:.4f} ms, two {times[2]:.4f} ms, the "
            f"CUDA-core kernel {device_ms(cores, ITERS):.4f} ms; big_attention_consumers picks "
            f"{K3.big_attention_consumers(B, 64, 8, torch.cuda.get_device_properties(0).multi_processor_count)}")


def site_timers() -> None:
    """The transformer site's three forms (K3 split, K5 one kernel, K6 big-C)
    and K6's attention kernel at the flagship's shapes in bf16, each read by
    both timers: device_ms (the device's work alone) and time_ms (events
    around back-to-back calls from the host: whichever of the host's launch
    path and the device is slower). It calls only entry points that older
    trees of the port (since prepare_site_weights) have too, so the same
    script times two trees alike."""
    import torch

    from mvdfusion_tpu_torch.ops import block as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s, std=1.0, dt=torch.float32: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    bf = torch.bfloat16
    x, a2, w = site_inputs(rnd, 16, 1024, 320, bf, False)
    wp = K3.prepare_site_weights(w, bf)
    xb, a2b, wb = site_inputs(rnd, 16, 64, 1280, bf, False)
    wbp, ln1 = K3.prepare_site_weights(wb, bf), rnd(16, 64, 1280, dt=bf)
    cases = (("K3 site (16, 1024, 320)", lambda: K3.launch_transformer_block(x, a2, wp, 8)),
             ("K5 site (16, 1024, 320)", lambda: K3.launch_transformer_block_single(x, a2, wp, 8)),
             ("K6 site (16, 64, 1280)", lambda: K3.launch_transformer_block_big(xb, a2b, wbp, 8)),
             ("K6 attention (16, 64, 1280)", lambda: K3.launch_big_attention(ln1, wb.qkv_w, 8)))
    for name, fn in cases:
        log(f"  site timers {name} bf16: device_ms {device_ms(fn, ITERS):.4f} ms, time_ms {time_ms(fn, ITERS):.4f} ms")


def k1_launches_a_call(iters: int = 10) -> None:
    """K1's device work a call at the flagship's 32^2 shape, read from a CUDA
    graph of `iters` calls: one kernel node a call and no other node (a copy,
    a memset or a second kernel would each be a node), and the graph's
    replay bit-equal to an eager call. A graph holds every launch, where a
    profiler trace may drop a kernel's record (the old trace of this count
    lost one in 150 sessions on the card)."""
    import ctypes

    import torch

    from mvdfusion_tpu_torch.ops import groupnorm as K1

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = (torch.randn(16, 1024, 320, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
    w, b = torch.ones(320, device=dev), torch.zeros(320, device=dev)
    want = K1.launch_group_norm(x, w, b, 32, 1e-5, "silu")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        ys = [K1.launch_group_norm(x, w, b, 32, 1e-5, "silu") for _ in range(iters)]
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n)) == 0,
          "K1: cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), nodes, ctypes.byref(n)) == 0,
          "K1: cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0, "K1: cuGraphNodeGetType failed")
        types.append(t.value)
    kernels = types.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL
    graph.instantiate()
    for y in ys:
        y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    log(f"  K1: {kernels / iters:g} kernels a call in a graph of {iters} calls (node types {sorted(set(types))}, "
        f"{len(types)} nodes)")
    check(kernels == iters and len(types) == iters, f"K1: {len(types)} graph nodes, {kernels} of them kernels, "
                                                    f"in {iters} calls: one kernel a call expected")
    check(all(torch.equal(y, want) for y in ys), "K1: the graph's replay differs from an eager call")


K4_CALL_LAUNCHES = 21  # gather + 3 layers x (2 LayerNorms, qkv + attention, proj, fc1, fc2) + pool + final GEMM


def crossview_checks(rnd, dev):
    """K4 (V=8) and K4b (V=15) against their plain versions at chip_smoke's
    shapes in bf16 (1 bf16 ulp of max|plain|, mean 3e-4 x max|plain|) and at
    small shapes in fp32, timed (each row keeps its call for the stages
    phase: crossview_stage_checks); then the gather and the qkv tile with
    the view attention alone, against their plain versions, in device time
    (the tile beside the standalone route: the fp32 qkv GEMM and
    crossview.cu's attention kernel)."""
    import torch
    import torch.nn.functional as F

    from mvdfusion_tpu_torch.ops import block as K3
    from mvdfusion_tpu_torch.ops import crossview as K4

    bf = torch.bfloat16
    rows = {}
    why = "bf16 operands rounded at the same points, fp32 residual stream on both sides, sums in another order"
    forms = {"crossview": (K4.launch_crossview, K4.crossview_plain, "mvdfusion_tpu/ops/crossview.py:562"),
             "crossview_two_phase": (K4.launch_crossview_two_phase, K4.crossview_two_phase_plain,
                                     "mvdfusion_tpu/ops/crossview.py:404")}
    inputs = {}
    for name, (launch, plain, src) in forms.items():
        log(f" K4 {name}")
        for dt, (V, Hh, hid, L, heads, out_dim) in ((torch.float32, (3, 8, 64, 2, 4, 48)),
                                                   (bf, (8 if name == "crossview" else 15, 32, 256, 3, 8, 768))):
            args, N, mlp, G = cv_inputs(K4, rnd, dev, V, Hh, hid, L, heads, out_dim, dt)
            if dt == bf:
                err = compare_ulp(f"{name} V={V} N={N} hid={hid}", launch(*args), plain(*args), why, mean_tol=3e-4)
            else:
                compare(f"{name} V={V} N={N} hid={hid}", launch(*args), plain(*args), 1e-4, "fp32 sum order", dt)
        inputs[name] = args
        kw = K4.prepare_crossview_weights(args[6], args[7], dt, heads, args[9])  # as GridAttn holds them
        call = lambda launch=launch, args=args, kw=kw: launch(*args[:6], *kw, *args[8:])
        ms = time_ms(call, ITERS)
        plain_ms = time_ms(lambda: plain(*args), max(2, ITERS // 4))
        T = N * V
        flops = (2 * T * (G + 4) * hid + L * (2 * T * hid * (4 * hid + 2 * mlp) + 4 * T * V * hid)
                 + 2 * N * hid * out_dim)
        bms, by = bound(flops, nbytes(*args[:6]) + nbytes(*args[6][:2]) + nbytes(*args[7]) + N * out_dim * 2)
        log(f"  {name}: {ms:.4f} ms, {flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.4f} ms")
        rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/crossview.cu (+ gemm_sm90.cu)",
                          replaces=src, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=None, stages_call=call,
                          shape=f"V={V}, N={N}, hid {hid}, {L} layers, {heads} heads, out {out_dim}, bf16")

    # the gather: phase-1 tokens within 1 bf16 ulp + gather_tokens_bound, the
    # two-phase stream GELU(float(token) + b_acc) of the kernel's own tokens
    for name, form, src in (("crossview_gather V=8", "single", "mvdfusion_tpu/ops/crossview.py:127"),
                            ("crossview_gather V=15", "two_phase", "mvdfusion_tpu/ops/crossview.py:404")):
        args = inputs["crossview" if form == "single" else "crossview_two_phase"]
        xy, pts, centers, mask, b_acc, maps_p, kg, _, heads, freqs = args
        V, N, hid = xy.shape[0], xy.shape[1], maps_p.shape[-1]
        geo = (xy, pts, centers, mask, maps_p, kg, freqs)
        tok = K4.launch_gather_tokens(*geo)
        ulps = compare_tokens(f"crossview phase-1 tokens V={V} N={N}", tok, K4.gather_tokens_plain(*geo).to(bf)
                              .transpose(0, 1), K4.gather_tokens_bound(*geo).transpose(0, 1))
        stream = K4.launch_gather(*geo[:4], b_acc, maps_p, kg, freqs, form)
        if form == "two_phase":
            compare(f"crossview gather stream V={V}, the kernel's tokens rounded, + b_acc, GELU", stream,
                    F.gelu(tok.float() + b_acc.float()[:, None, :]).reshape(-1, hid), 1e-5,
                    "the same fp32 GELU of the same rounded token", torch.float32)
        kgp = K4.prepare_crossview_weights(kg, args[7], bf, heads, freqs)[0]
        run = lambda: K4.launch_gather(*geo[:4], b_acc, maps_p, kgp, freqs, form)
        ms = device_ms(run, ITERS)
        plain_ms = device_ms(lambda: K4.gather_stream_plain(*geo[:4], b_acc, maps_p, kg, freqs, form == "two_phase"),
                             max(2, ITERS // 4))
        G, T = kg.kall.shape[0], N * V
        bms, by = bound(2 * T * (G + 4) * hid, nbytes(xy, pts, centers, mask, b_acc, maps_p, kg.kall, kg.kmask)
                        + T * hid * 4)
        log(f"  {name} ({form}): {ms:.4f} ms, bound {bms:.4f} ms ({by}); phase-1 tokens at most {ulps:.2f} ulp")
        rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/crossview.cu (cv_gather_mma_kernel)",
                          replaces=src, max_abs_err=(stream - K4.gather_stream_plain(
                              *geo[:4], b_acc, maps_p, kg, freqs, form == "two_phase")).abs().max().item(),
                          ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
                          shape=f"V={V}, N={N}, hid {hid}, G {G}, the {form} form's fp32 stream",
                          phase="slice" if form == "single" else "eval", launch_key="cv_gather_mma")

    # the qkv tile with the view attention, beside the standalone route
    for V, phase in ((8, "slice"), (15, "eval")):
        args = inputs["crossview" if V == 8 else "crossview_two_phase"]
        N, hid, heads = args[0].shape[1], args[5].shape[-1], args[8]
        kw = K4.prepare_crossview_weights(args[6], args[7], bf, heads, args[9])[1]
        h = rnd(N * V, hid, dt=bf)
        qw, qb = kw.qkv_w[0], kw.qkv_b[0]
        want = K4.view_attention_plain(h, qw, qb, V, heads)
        name = f"crossview_qkv_attention V={V}"
        err = compare_ulp(f"{name} (fused)", K4.view_attention(h, qw, qb, V, heads), want,
                          "both round the fp32 attention output once", mean_tol=1e-4)
        compare_ulp(f"{name} (standalone)", K4.view_attention(h, qw, qb, V, heads, route="standalone"), want,
                    "both round the fp32 attention output once", mean_tol=1e-4)
        check(torch.equal(K4.view_attention(h, qw, qb, V, heads), K4.view_attention(h, qw, qb, V, heads)),
              f"{name}: two runs differ")
        ms = device_ms(lambda: K4.view_attention(h, qw, qb, V, heads), ITERS)
        alone_ms = device_ms(lambda: K4.view_attention(h, qw, qb, V, heads, route="standalone"), ITERS)
        plain_ms = device_ms(lambda: K4.view_attention_plain(h, qw, qb, V, heads), max(2, ITERS // 4))
        M = N * V
        bms, by = bound(2 * M * hid * 3 * hid + 4 * M * V * hid, nbytes(h, qw, qb) + M * hid * 2)
        log(f"  {name}: the qkv tile {ms:.4f} ms; the standalone route (fp32 qkv GEMM + attention kernel) "
            f"{alone_ms:.4f} ms; bound {bms:.4f} ms ({by}); route {K4.attention_route(bf, V, hid, heads)}")
        rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/gemm_sm90.cu "
                          "(qkv_attention_sm90_kernel; viewattn.cuh)", replaces="mvdfusion_tpu/ops/crossview.py:278",
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
                          standalone_ms=alone_ms, shape=f"h ({M}, {hid}) bf16, qkv (768, 256) packed per head, "
                          f"{heads} heads, V={V}", phase=phase, launch_key="cv_qkv_attention")
    return rows


def gn_pass_times(K1, x, w, b, a, sh) -> None:
    """Log K7's passes on x by device_ms, each against its bound (bytes: the
    stats pass reads x once, the apply pass reads it and writes y), and the
    whole."""
    st = device_ms(lambda: K1.launch_fold(x, w, b, 32, 1e-6, True), ITERS)
    ap = device_ms(lambda: K1.launch_apply_affine(x, a, sh), ITERS)
    k7 = device_ms(lambda: K1.launch_group_norm_tiled(x, w, b, 32, 1e-6), ITERS)
    b_st, b_ap = nbytes(x) / PEAK_BYTES * 1e3, 2 * nbytes(x) / PEAK_BYTES * 1e3
    log(f"  K7 {tuple(x.shape)} {x.dtype}: stats pass with the fold {st:.4f} ms "
        f"(bound {b_st:.4f}, {b_st / st:.1%}), apply pass {ap:.4f} ms (bound {b_ap:.4f}, {b_ap / ap:.1%}), "
        f"both {k7:.4f} ms (bound {b_ap:.4f}, {b_ap / k7:.1%}; the passes' own floor, two reads and one write, "
        f"{b_st + b_ap:.4f})")


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
    # norm_out (timed, act none as K1's row); three launches bit-equal
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
            check(all(torch.equal(got, K1.launch_group_norm_tiled(x, w, b, 32, 1e-6, act)) for _ in range(2)),
                  f"{name}: repeated launches differ")
    ms = device_ms(lambda: K1.launch_group_norm_tiled(x, w, b, 32, 1e-6), ITERS)
    a, sh = K1.launch_fold(x, w, b, 32, 1e-6, True)
    plain_ms = device_ms(lambda: K1.group_norm_tiled_plain(x, w, b, 32, 1e-6), ITERS)
    lib_ms = device_ms(lambda: F.group_norm(x.transpose(1, 2), 32, w.to(bf), b.to(bf), 1e-6), ITERS)
    bms, by = bound(10 * x.numel(), 2 * nbytes(x) + nbytes(w, b))
    gn_pass_times(K1, x, w, b, a, sh)
    rows["groupnorm_tiled"] = dict(
        name="groupnorm_tiled", route="cuda",
        source="mvdfusion_tpu_torch/csrc/groupnorm.cu (gn_stats_kernel with its fold, gn_apply_kernel)",
        replaces="mvdfusion_tpu/ops/groupnorm.py:104", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, shape="x (8, 65536, 128) bf16, 32 groups, eps 1e-6 (the decoder's norm_out)")

    # K8 statistics: the eval chunk's 128^2 x 512 (B=7) and the decoder's
    # 256^2 x 256 (timed); the fold's outputs are fp32 on both sides; the
    # yardstick is the (B, G) moments alone, torch.var_mean of fp32 x
    log(" K8 gn_fold_affine")
    err = 0.0
    for dt, shape in ((torch.float32, (2, 3000, 96)), (bf, (7, 16384, 512)), (bf, (8, 65536, 256))):
        x = rnd(*shape, dt=dt) * 3 + 1
        w, b = 1 + rnd(shape[-1], std=0.1), rnd(shape[-1], std=0.1)
        (ka, kb), (pa, pb) = K8.launch_gn_fold_affine(x, w, b, 32, 1e-6), K8.gn_fold_affine_plain(x, w, b, 32, 1e-6)
        err = max(err, compare(f"gn_fold_affine {shape} a", ka, pa, 1e-4, "fp32 sums in another order", dt),
                  compare(f"gn_fold_affine {shape} b", kb, pb, 1e-4, "fp32 sums in another order", dt))
        again = [K8.launch_gn_fold_affine(x, w, b, 32, 1e-6) for _ in range(2)]
        check(all(torch.equal(u, ka) and torch.equal(v, kb) for u, v in again), f"gn_fold_affine {shape}: "
              "repeated launches differ")
    ms = device_ms(lambda: K8.launch_gn_fold_affine(x, w, b, 32, 1e-6), ITERS)
    plain_ms = device_ms(lambda: K8.gn_fold_affine_plain(x, w, b, 32, 1e-6), ITERS)
    B, N, C = x.shape
    xg = x.float().view(B, N, 32, C // 32)
    lib_ms = device_ms(lambda: torch.var_mean(xg, dim=(1, 3)), ITERS)
    bms, by = bound(3 * x.numel(), nbytes(x, w, b, ka, kb))
    log(f"  gn_fold_affine {tuple(x.shape)}: {ms:.4f} ms, bound {bms:.4f} ms ({bms / ms:.1%}), "
        f"{nbytes(x) / ms / 1e9:.2f} TB/s; moments only (torch.var_mean over (B, G) of fp32 x, a yardstick, "
        f"not the same function) {lib_ms:.4f} ms")
    rows["gn_fold_affine"] = dict(
        name="gn_fold_affine", route="cuda",
        source="mvdfusion_tpu_torch/csrc/groupnorm.cu (gn_stats_kernel with its fold)",
        replaces="mvdfusion_tpu/ops/conv3x3.py:62", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, library="torch.var_mean of fp32 x over (B, G): moments only",
        shape="x (8, 65536, 256) bf16, 32 groups")

    # K8 conv: ragged tiles in fp32 (TX 32 over 20 x 40; TX 64 over W = 136,
    # odd H, Cout 8), the eval chunk's 64^2 x 512 with a residual, the
    # decoder's 64^2 x 512 and its 256^2 256 -> 128 with the nin residual
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
    log(f"  conv3x3 (8, 256, 256, 256 -> 128) + res: {ms:.4f} ms, {flops / 1e9:.1f} GFLOP, {flops / ms / 1e9:.1f} "
        f"TFLOP/s, bound {bms:.4f} ms; the library yardstick is F.conv2d (cuDNN, channels-last bf16) + bias without "
        f"the prologue and residual")
    rows["conv3x3"] = dict(
        name="conv3x3", route="cuda", source="mvdfusion_tpu_torch/csrc/conv3x3.cu",
        replaces="mvdfusion_tpu/ops/conv3x3.py:95", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, shape="x (8, 256, 256, 256) bf16 -> 128 channels, + residual")
    return rows


# the site GEMM's distinct shapes on the three driven paths, bf16 operands:
# (M, N, K, epilogue, phase, the TPU kernel whose product it is). M: the
# flagship's CFG batch 16 x 1024 (32^2) and x 256 (16^2) tokens, the DiT's
# 8 views x 8192 points and the 8192 pooled points; the eval path's CFG
# batch 30 and 15 views x 15360 points; the scenes phase's CFG batch 60 at
# the UNet's sites (its GridAttn runs a scene at a time, at the eval path's
# shapes); the forms route's C=1280 8^2 sites (16 x 64). N is the weight's rows: GEGLU's packed value and gate rows are
# twice the inner width. Epilogues as the path runs them: "res" the out-projection's
# h0 + attn2 (a row per batch element at 32^2, a map at 16^2 and 8^2),
# "ff" FF out + h2, "ff1" the big-C form's one rounding, "gate" the DiT's
# gated in-place residual on its fp32 stream, "qkv" the site's qkv (no
# bias). The DiT's qkv product runs in the qkv + attention tile
# (crossview_checks).
_SITE, _FF, _BIGC, _DIT = ("mvdfusion_tpu/ops/block.py:315", "mvdfusion_tpu/ops/block.py:327",
                           "mvdfusion_tpu/ops/block.py:338", "mvdfusion_tpu/ops/crossview.py:188")
GEMM_ROWS = [
    *((M, N, K, epi, phase, src)
      for phase, (B, V) in (("slice", (16, 8)), ("eval", (30, 15)))
      for M, N, K, epi, src in (
          (B * 1024, 320, 320, "res_row", _SITE), (B * 1024, 960, 320, "qkv", _SITE),
          (B * 1024, 2560, 320, "geglu", _FF), (B * 1024, 320, 1280, "ff", _FF),
          (B * 256, 640, 640, "res_map", _SITE), (B * 256, 1920, 640, "qkv", _SITE),
          (B * 256, 5120, 640, "geglu", _FF), (B * 256, 640, 2560, "ff", _FF),
          (V * V * 1024, 256, 256, "gate", _DIT),
          (V * V * 1024, 512, 256, "gelu", _DIT), (V * V * 1024, 256, 512, "gate", _DIT),
          (V * 1024, 768, 256, "none", _DIT))),
    (1024, 1280, 1280, "res_map", "forms", _BIGC), (1024, 10240, 1280, "geglu", "forms", _BIGC),
    (1024, 1280, 5120, "ff1", "forms", _BIGC),
    *((M, N, K, epi, "scenes", src) for M, N, K, epi, src in (
        (_B60 * 1024, 320, 320, "res_row", _SITE), (_B60 * 1024, 960, 320, "qkv", _SITE),
        (_B60 * 1024, 2560, 320, "geglu", _FF), (_B60 * 1024, 320, 1280, "ff", _FF),
        (_B60 * 256, 640, 640, "res_map", _SITE), (_B60 * 256, 1920, 640, "qkv", _SITE),
        (_B60 * 256, 5120, 640, "geglu", _FF), (_B60 * 256, 640, 2560, "ff", _FF))),
]


def gemm_checks(rnd):
    """The wgmma GEMM against its plain version at every GEMM_ROWS shape
    (1 bf16 ulp of max|plain| and a mean of 1e-4 x max|plain| for bf16
    outputs, GEGLU's rounding chain as compare_geglu allows it, the residual
    stream's 1e-4 x max(1, max|plain|) for fp32 ones),
    timed beside block.cu's wmma tile on the same operands, the plain version
    and torch.matmul (cuBLAS, the bare product), all in device time
    (device_ms: at the smaller shapes one call's host path outlasts the
    kernel)."""
    import torch

    from mvdfusion_tpu_torch.ops import block as K3

    bf = torch.bfloat16
    rows = {}
    log(" site GEMM (gemm_sm90.cu)")
    for M, N, K, epi, phase, src in GEMM_ROWS:
        a, w = rnd(M, K, dt=bf), rnd(N, K, std=K**-0.5, dt=bf)
        kw = dict(bias=None if epi == "qkv" else rnd(N, std=0.1))
        act = {"geglu": K3.ACT_GEGLU, "gelu": K3.ACT_GELU}.get(epi, K3.ACT_NONE)
        n_out = N // 2 if act == K3.ACT_GEGLU else N
        res = None
        if epi in ("res_row", "res_map"):
            div = 1024 if epi == "res_row" else 1  # attn2 a row per 32^2 image
            kw.update(res1=rnd(M, n_out, dt=bf), res2=rnd(M // div, n_out, dt=bf), res2_div=div, steps=True)
        elif epi in ("ff", "ff1"):
            kw.update(res1=rnd(M, n_out, dt=bf), steps=epi == "ff")
        elif epi == "geglu":
            kw.update(steps=True)
        elif epi == "gate":  # in place on the fp32 stream
            res = rnd(M, n_out)
            kw.update(gate=rnd(n_out, std=0.5))
        elif epi == "f32":
            kw.update(out_dtype=torch.float32)
        kw["act"] = act

        buf = None if res is None else res.clone()

        def run(route, plain=False, fresh=True):
            """`fresh`: the in-place residual on a copy of `res`; else on
            `buf`, drifting from call to call (for timing)."""
            r = None if res is None else (res.clone() if fresh else buf)
            extra = {} if r is None else dict(res1=r, out=r)
            f = K3.gemm_plain if plain else (lambda *x, **k: K3.gemm(*x, route=route, **k))
            return f(a, w, **kw, **extra)

        got, want = run("sm90"), run(None, plain=True)
        name = f"gemm_sm90 {M}x{N}x{K}"
        what = f"{epi} epilogue, the {phase} path"
        if epi == "geglu":
            err = compare_geglu(f"{name} ({what})", got, want, a, w, kw["bias"])
        elif got.dtype == bf:
            err = compare_ulp(f"{name} ({what})", got, want, "both round the fp32 sums where the TPU kernels "
                              "round; only roundings split by the sums' order differ", mean_tol=1e-4)
        else:
            err = compare(f"{name} ({what})", got, want, 1e-4, "fp32 sums in another order", torch.float32)
        check(torch.equal(got, run("sm90")), f"{name}: two runs differ")
        ms = device_ms(lambda: run("sm90", fresh=False), ITERS)
        wmma_ms = device_ms(lambda: run("wmma", fresh=False), ITERS)
        plain_ms = device_ms(lambda: run(None, plain=True, fresh=False), max(2, ITERS // 4))
        lib_ms = device_ms(lambda: torch.matmul(a, w.t()), ITERS)
        host_ms = time_ms(lambda: run("sm90", fresh=False), ITERS)
        flops = 2 * M * N * K
        out_bytes = M * n_out * got.element_size()
        bms, by = bound(flops, nbytes(a, w, kw.get("bias"), kw.get("res1"), kw.get("res2"), kw.get("gate"), res)
                        + out_bytes)
        log(f"  {name}: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s; wmma tile {wmma_ms:.4f} ms "
            f"({wmma_ms / ms:.2f}x); cuBLAS {lib_ms:.4f} ms; bound {bms:.4f} ms ({by}); back-to-back calls "
            f"from the host {host_ms:.4f} ms a call")
        check(ms < wmma_ms, f"{name}: the wgmma kernel ({ms:.4f} ms) is not faster than the wmma tile "
                            f"({wmma_ms:.4f} ms)")
        rows[name] = dict(name=name, route="cuda", source="mvdfusion_tpu_torch/csrc/gemm_sm90.cu", replaces=src,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                          wmma_ms=wmma_ms, shape=f"({M}, {K}) x ({N}, {K})^T, {what}",
                          phase=phase, launch_key=("sm90", M, N, K))
    return rows


def check_gn_shapes(shapes, B: int, steps: int) -> int:
    """K1's calls at the UNet's CFG batch B (_lib.GN_SHAPES) held to
    `steps` x GN_STEP; returns the calls at other batches (the VAE's)."""
    got = {(N, C, act): n for (b, N, C, act), n in shapes.items() if b == B}
    want = {key: steps * n for key, n in GN_STEP.items()}
    log(f"  K1 by shape at batch {B}: {got}")
    check(got == want, f"K1's calls by (N, C, act) at batch {B}: {got}, GN_STEP implies {want}")
    return sum(n for (b, *_), n in shapes.items() if b != B)


# ---------------------------------------------------------------- phase 4
def build_model(device: str = "cuda", cfg=None, seed: int = SEED):
    """The full-width model (or `cfg`) with random weights from `seed`,
    towers cast to cfg.dtype."""
    import torch

    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_

    cfg = cfg or ViewFusionConfig()
    model = randomize_(ViewFusion(cfg, device=torch.device(device)), seed).cast_for_inference().eval()
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


def answer(model, scene, steps: int, seed: int, dev, **sample_kw):
    """One flagship request on random images from `seed`: prepare_batch,
    `steps` DDIM steps at CFG 2.5 (eta=1 on uniform timesteps unless
    `sample_kw` says otherwise), decode; checks shapes, finiteness and the
    [0, 1] image range. Returns the latents, the prepared sampler inputs and
    the seconds of each part."""
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
        res = ddim_sample(model, *prepared, 2.5, num_steps=steps, generator=g, **sample_kw)
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
        "attention_site_n1024": REQUESTS * steps * SITES_PER_LEVEL,  # K2 inside K3, 32^2 sites
        "attention_site_n256": REQUESTS * steps * SITES_PER_LEVEL,  # and 16^2 sites
        "crossview": REQUESTS * steps,
        "crossview_two_phase": 0,
        "cv_gather_mma": REQUESTS * steps,  # K4's gather, the tensor-core form
        "cv_gather_simt": 0,
        "cv_qkv_attention": REQUESTS * steps * DIT_LAYERS,  # the DiT's qkv + attention tile
        "cv_attention": 0,
        "transformer_block_single": 0,
        "transformer_block_big": 0,
        "gemm_sm90": REQUESTS * steps * GEMMS_PER_STEP,
        "gemm_wmma": 0,
        "layernorm": REQUESTS * steps * 2 * LN_PER_STEP,  # LN1 and LN3 of the 16 split sites
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    vae = check_gn_shapes(_lib.GN_SHAPES, GN_BATCH["slice"], REQUESTS * steps)
    check(vae == REQUESTS * (VAE_GN_ENCODE + VAE_GN_DECODE), f"K1 in the VAE: {vae} calls")
    counts.update(_lib.GEMM_SHAPES)
    counts.update(_lib.GN_SHAPES)
    counts.update(_lib.LN_SHAPES)
    if profile:
        profile_steps(model, prepared, profile)
    B = len(scene["target_idx"])
    mean = lambda a: sum(a) / len(a)
    log(f"  slice: {mean(step_s):.4f} s/step, {B / mean(req_s):.3f} views/s ({REQUESTS} requests of {B} views, "
        f"{steps} steps), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card}")
    return counts


# ---------------------------------------------------------------- phase 5
def run_eval(steps: int, card: str, device: str = "cuda", cfg=None, model=None, profile: int = 0):
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
        "attention_site_n1024": steps * SITES_PER_LEVEL,
        "attention_site_n256": steps * SITES_PER_LEVEL,
        "crossview_two_phase": steps,
        "crossview": 0,
        "cv_gather_mma": steps,
        "cv_gather_simt": 0,
        "cv_qkv_attention": steps * DIT_LAYERS,
        "cv_attention": 0,
        "gemm_sm90": steps * GEMMS_PER_STEP,
        "gemm_wmma": 0,
        "layernorm": steps * 2 * LN_PER_STEP,
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    check_gn_shapes(_lib.GN_SHAPES, GN_BATCH["eval"], steps)
    counts.update(_lib.GEMM_SHAPES)
    counts.update(_lib.GN_SHAPES)
    counts.update(_lib.LN_SHAPES)
    if profile:
        profile_steps(model, eval_prepared(model, dev), profile, what="eval, CFG batch 30",
                      feed_prev_depth=cfg.feed_prev_depth)
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
        counts, shapes = dict(_lib.LAUNCHES), {**_lib.GEMM_SHAPES, **_lib.LN_SHAPES}
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
        "big_attention": steps * SITES_PER_LEVEL,  # K6's attention kernel, one a site
        "transformer_block": steps * SITES_PER_LEVEL,
        "attention_site_n1024": 0,  # the 32^2 sites run K5, whose attention phase is K2's tile
        "attention_site_n256": steps * SITES_PER_LEVEL,
        "groupnorm": steps * (55 - SITES_PER_LEVEL) + VAE_GN_ENCODE + VAE_GN_DECODE,
        "attention": 24,
        "crossview": steps,
        "crossview_two_phase": 0,
        "cv_gather_mma": steps,
        "cv_qkv_attention": steps * DIT_LAYERS,
        "cv_attention": 0,
        "gemm_sm90": steps * GEMMS_PER_STEP_FORMS,
        "gemm_wmma": 0,
        "layernorm": steps * 2 * (LN_PER_STEP // 2 + SITES_PER_LEVEL),  # K3's 8 sites and K6's 8
    }
    log(f"  launch counts {counts}, implied {want}")
    for k, n in want.items():
        check(counts.get(k, 0) == n, f"{k}: {counts.get(k, 0)} launches, the path implies {n}")
    counts.update(shapes)
    if profile:
        set_forms(True)
        try:
            profile_steps(model, prepared, profile, what="forms")
        finally:
            set_forms(False)
    log(f"  forms: {ts / steps:.4f} s/step, {B / (tp + ts + td):.3f} views/s (1 request of {B} views, {steps} steps), "
        f"one-step latent gap {step_err:.3e}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"on {card}")
    return counts


# ---------------------------------------------------------------- phase 7
VAE_SWITCHES = ("MVDF_GN_TILED", "MVDF_CONV3X3")
# the vae phase's routes and their switches; "plain_gn" is the default route
# with the plain GroupNorm at the large maps (vae_route). MVDF_GN_TILED=1
# alone has no route here: on the card it takes the default route's path
VAE_ROUTES = {"default": (False, False), "plain_gn": (False, False), "both": (True, True)}


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


@contextlib.contextmanager
def vae_route(route: str):
    """Run the VAE on `route` of VAE_ROUTES: its switches set, and for
    "plain_gn" GroupNorm32 asking gn_route as for a CPU tensor (the plain
    GroupNorm at the large maps, patched here alone); all undone after."""
    import mvdfusion_tpu_torch.nn.layers as layers

    real_route = layers.gn_route
    set_vae_forms(*VAE_ROUTES[route])
    if route == "plain_gn":
        layers.gn_route = lambda shape, groups, device_type, gated=True: real_route(shape, groups, "cpu", gated)
    try:
        yield
    finally:
        layers.gn_route = real_route
        set_vae_forms(False, False)


def run_vae(card: str, device: str = "cuda", cfg=None, model=None):
    """The VAE on each route: encode of the flagship's 9 images, decode of 8
    latents and the eval path's chunked decode of 15 views; the default
    route against the plain GroupNorm's and the switched forms against the
    default route, on the same inputs. Returns the launches of the whole
    phase. `device`/`cfg` let it be rehearsed on the CPU at the tiny config
    (launch counts are then 0)."""
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

    for route in VAE_ROUTES:
        with vae_route(route):
            run((route, "encode"), model.encode_images, images)
            run((route, "decode"), model.decode_latents, z)
            run((route, "decode_15"), model.decode_latents_chunked, z15)
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
    for (route, what), o in out.items():
        if route == "plain_gn":
            gaps[route, what] = compare(f"vae {what}, the default route vs the plain GroupNorm's",
                                        out[("default", what)], o, 3e-2, "K7's fp32 statistics summed in another "
                                        "order and its folded affine; bf16 activations", cfg.dtype)
        elif route != "default":
            gaps[route, what] = compare(f"vae {what}, {route} vs the default route", o, out[("default", what)], 3e-2,
                                        "bf16 rounding at other points: K8's single rounding after conv + bias + "
                                        "residual", cfg.dtype)
    if dev.type != "cuda":
        return {}
    chunks = -(-EVAL_TARGETS // 8)  # decode_latents_chunked's chunks of 8
    for (route, what), launched in counts.items():
        per_decode = VAE_LAUNCHES[route]["decode" if what == "decode_15" else what]
        want = {k: per_decode.get(k, 0) * (chunks if what == "decode_15" else 1) for k in VAE_KERNELS}
        got = {k: launched.get(k, 0) for k in VAE_KERNELS}
        check(got == want, f"vae {route} {what}: launches {got}, the path implies {want}")
    log(f"  vae: largest gap between routes {max(gaps.values()):.3e}, on {card}")
    vae_route_times(model, images, z, card)
    return dict(total)


def vae_route_times(model, images, z, card: str) -> None:
    """Host time of encode (9 images) and decode (8 latents) per VAE route:
    one warm-up call (with both forms on, the call that packs each conv
    weight, so packing is excluded), then VAE_ITERS calls, each timed alone
    between device syncs; logs the median and the spread."""
    import statistics

    import torch

    for route in VAE_ROUTES:
        with vae_route(route):
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


# ---------------------------------------------------------------- phase 8
# keys a real mvdfusion_sep23.pt carries that no parameter takes: the
# scheduler's buffers, GridAttn's dead t_embedder, the CLIP text tower's
# leftovers (tests/test_convert_full.py); any shapes do
DEAD_KEYS = {
    "scheduler.betas": (1000,),
    "scheduler.alphas_cumprod": (1000,),
    "view_attn.t_embedder.mlp.0.weight": (256, 256),
    "view_attn.t_embedder.mlp.0.bias": (256,),
    "clip_image_encoder.model.token_embedding.weight": (16, 768),
    "clip_image_encoder.model.positional_embedding": (77, 768),
    "clip_image_encoder.model.ln_final.weight": (768,),
    "clip_image_encoder.model.text_projection": (768, 768),
    "clip_image_encoder.model.logit_scale": (),
}
WEIGHTS_STEPS = 2  # DDIM steps of each of the phase's requests


def run_weights(card: str, device: str = "cuda", cfg=None, model=None, out_dir=None) -> dict:
    """Real weights at full width: the slice phase's model written as a
    reference-layout file (its state and DEAD_KEYS, torch.save) and loaded
    by convert/reference.py::load_viewfusion into a second model built from
    another seed whose prepared weights were cached by one flagship step
    first; both models answer the flagship request on the same noise and
    must agree bit for bit (within the source's own run-to-run spread if
    that is not 0). Then a pre-surgery zero123 UNet file through
    load_zero123_unet, and one eta=0 quad request (K1-K4 launched, the
    same latents under other step noise). Files go to `out_dir` (the
    git-ignored build/ directory) and are deleted. `device`/`cfg` let it be
    rehearsed on the CPU at the tiny config (launch counts are then 0).
    Returns the eta=0 request's launches."""
    import torch

    from mvdfusion_tpu_torch.convert import reference as P
    from mvdfusion_tpu_torch.convert.surgery import ZERO123_PARAM_MAPPER, ZERO123_REMOVE_KEYS
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    dev = torch.device(device)
    src = model if model is not None else build_model(device, cfg)
    cfg = src.cfg
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out_dir = Path(out_dir) if out_dir is not None else HERE / "build"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = [out_dir / "weights_sep23.pt", out_dir / "weights_zero123.ckpt"]
    dst = None
    try:
        # 1. the reference-layout file
        g = torch.Generator().manual_seed(SEED + 7)
        dead = {k: torch.randn(shape, generator=g) for k, shape in DEAD_KEYS.items()}
        ref_sd = src.state_dict()
        sync()
        t0 = time.perf_counter()
        torch.save({**ref_sd, **dead}, files[0])
        write_s = time.perf_counter() - t0
        gb = files[0].stat().st_size / 1e9
        log(f"  wrote {files[0].name}: {gb:.3f} GB ({len(ref_sd)} parameters + {len(dead)} dead keys) "
            f"in {write_s:.2f}s ({gb / write_s:.2f} GB/s)")

        # 2. into a second model whose prepared weights are cached
        dst = build_model(device, cfg, seed=SEED + 100)
        scene = flagship_scene(dst, dev)
        answer(dst, scene, 1, SEED + 1, dev)
        sync()
        t0 = time.perf_counter()
        stats = P.load_viewfusion(dst, str(files[0]), verbose=False)
        sync()
        load_s = time.perf_counter() - t0
        check(stats.missing == [], f"load_viewfusion: {len(stats.missing)} missing keys, e.g. {stats.missing[:3]}")
        check(sorted(stats.unused) == sorted(DEAD_KEYS), f"load_viewfusion: unused keys {sorted(stats.unused)}")
        check(len(stats.written) == len(ref_sd), f"load_viewfusion wrote {len(stats.written)} of {len(ref_sd)}")
        dst_sd = dst.state_dict()
        bad = [k for k, v in ref_sd.items() if not torch.equal(dst_sd[k], v)]
        check(not bad, f"{len(bad)} parameters differ from the source after the load, e.g. {bad[:3]}")
        log(f"  load_viewfusion: {len(stats.written)} written, 0 missing, unused = the {len(DEAD_KEYS)} dead keys, "
            f"every parameter equal to the source's; {load_s:.2f}s ({gb / load_s:.2f} GB/s)")

        # 3. both models on the same noise, kernels on
        runs = [answer(m, scene, WEIGHTS_STEPS, SEED + 11, dev)[0] for m in (src, src, dst)]
        spread = (runs[1] - runs[0]).abs().max().item()
        gap = (runs[2] - runs[0]).abs().max().item()
        log(f"  flagship at {WEIGHTS_STEPS} steps: loaded vs source max|diff| {gap:.3e}, the source's run-to-run "
            f"spread {spread:.3e}")
        check(gap <= spread, f"the loaded model's latents differ from the source's by {gap:.3e} > the run-to-run "
                             f"spread {spread:.3e}: stale prepared weights?")

        # 4. a pre-surgery zero123 UNet: the grafted aligned_attn_* layers
        # absent, the shifted rows at their old positions, the shape-changed
        # convs dropped, under model.diffusion_model.
        pre = P.UNET_PREFIX
        inv = {v: k for k, v in ZERO123_PARAM_MAPPER.items()}
        gz = torch.Generator(device=dev).manual_seed(SEED + 8)
        state, want = {}, {}
        for k, v in dst_sd.items():
            name = k[len(pre):]
            if k.startswith(pre) and "aligned_attn_" not in name and name not in ZERO123_REMOVE_KEYS:
                want[k] = torch.randn(v.shape, generator=gz, device=dev).to(v.dtype)
                state["model.diffusion_model." + inv.get(name, name)] = want[k]
        sync()
        t0 = time.perf_counter()
        torch.save({"state_dict": state}, files[1])
        zwrite_s = time.perf_counter() - t0
        zgb = files[1].stat().st_size / 1e9
        del state
        sync()
        t0 = time.perf_counter()
        zstats = P.load_zero123_unet(dst, str(files[1]), verbose=False)
        sync()
        zload_s = time.perf_counter() - t0
        kept = [k[len(pre):] for k in zstats.missing]
        check(zstats.unused == [] and sorted(zstats.written) == sorted(want),
              f"load_zero123_unet: {len(zstats.written)} written of {len(want)}, unused {zstats.unused[:3]}")
        check(set(ZERO123_REMOVE_KEYS) <= set(kept) and all("aligned_attn_" in k or k in ZERO123_REMOVE_KEYS
                                                             for k in kept), f"rows kept at their values: {kept[:5]}")
        dst_sd = dst.state_dict()
        check(all(torch.equal(dst_sd[k], v) for k, v in want.items()), "a zero123 row did not land")
        check(all(torch.equal(dst_sd[pre + k], ref_sd[pre + k]) for k in kept),
              "an aligned_attn_* row or a removed conv changed")
        log(f"  load_zero123_unet: {zgb:.3f} GB file written in {zwrite_s:.2f}s, {len(want)} rows landed after the surgery, {len(kept)} kept "
            f"their values ({sum('aligned_attn_' in k for k in kept)} aligned_attn_* and the "
            f"{len(ZERO123_REMOVE_KEYS)} removed convs); {zload_s:.2f}s")
        del want
        dst = None

        # 5. a deterministic request: eta=0 on quad timesteps
        _lib.reset_launches()
        lat, prepared, _ = answer(src, scene, WEIGHTS_STEPS, SEED + 12, dev, eta=0.0, method="quad")
        counts = dict(_lib.LAUNCHES)
        ls, B, D = cfg.latent_size, len(scene["target_idx"]), cfg.n_pts_per_ray
        gn = torch.Generator(device=dev).manual_seed(SEED + 13)
        draw = lambda *shape: torch.randn(shape, generator=gn, device=dev)
        init, jitter = draw(B, ls, ls, 5), draw(WEIGHTS_STEPS, B, ls, ls, D)
        with torch.no_grad():
            again = [ddim_sample(src, *prepared, 2.5, num_steps=WEIGHTS_STEPS, eta=0.0, method="quad",
                                 init_noise=init, jitter_noise=jitter,
                                 step_noise=draw(WEIGHTS_STEPS, B, ls, ls, 5)).latents for _ in range(2)]
        eta0_gap = (again[1] - again[0]).abs().max().item()
        log(f"  eta=0 quad request: max|latent| {lat.abs().max().item():.3f}; two runs from one initial noise "
            f"under other step noise differ by {eta0_gap:.3e}; launches {counts}")
        check(eta0_gap <= spread, f"eta=0 runs differ by {eta0_gap:.3e} under other step noise")
        if dev.type == "cuda":
            for k in ("groupnorm", "attention", "transformer_block", "crossview"):
                check(counts.get(k, 0) > 0, f"{k}: no launch in the eta=0 request")
        return counts
    finally:
        del dst
        for f in files:
            f.unlink(missing_ok=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 9
# The SCENES scenes of the scenes phase in one sampler pass, batched, against
# one at a time. On the CPU the two are bit-equal (the port's own tests, in
# bf16 too); on the card cuBLAS, cuDNN and K1 pick their kernels for a CFG
# batch of 60 there and 30 here, so they round apart. One sampler step on
# the same inputs (latents after one DDIM step) is held twice to the forms
# phase's one-step rule, SCENES_STEP_RTOL x max(1, max|reference|): the
# batched step against each scene's step alone, and the batched step with
# the kernels against the same batched step under the kernel-off switch
# (every kernel of the UNet at the batch of 60 against its plain version,
# with the K1, LayerNorm and site GEMM rows of the kernels phase at that
# batch). After --eval-steps eta=1 steps the random-weight model has
# amplified the roundings element by element (measured on an H100 at 10
# steps: max|diff| 5.4e-2 on pred_rgb, 0.72 on one pred_depth element of
# [0, 1], means 4.7e-3 and 7.1e-3; PERF.md), so no bound on the max of the
# sampled fields holds below their range: they are held in the mean, their
# mean |batched - alone| at most SCENES_MIX_FRACTION of the mean |scene 0 -
# scene 1| alone, the gap a scene reading its batch mate's conditioning
# would open. The ground truth (prepare_batch and the decode run once a
# scene either way) is held bit-equal.
SCENES_STEP_RTOL = 3e-2
SCENES_MIX_FRACTION = 0.1
SCENE_FIELDS_EXACT = ("gt_rgb", "gt_depth", "input_depth")


def gso_scenes(model, n: int, dev):
    """`n` in-memory scenes as the eval phase writes one: the 16-view GSO rig,
    random images from a numpy seed, 1 input and 15 target views."""
    import numpy as np
    import torch

    from mvdfusion_tpu_torch.data.rigs import AZIMUTHS_16, ELEVATIONS_16, fixed_rig

    ls = model.cfg.latent_size
    IMG = ls * 2 ** (len(model.cfg.vae_ch_mult) - 1)
    R, T, f, c = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)
    images = np.random.default_rng(SEED).uniform(size=(n, 16, IMG, IMG, 3)).astype(np.float32)
    sel = np.linspace(0, 15, 1 + EVAL_TARGETS).astype(np.int64)
    on = lambda a: torch.as_tensor(a, device=dev)
    rig = [on(np.stack([a] * n)) for a in (R, T, f, c)]
    return [on(images), *rig, on(sel[:1]), on(sel[1:])]


def run_scenes(steps: int, card: str, device: str = "cuda", cfg=None, model=None, profile: int = 0) -> dict:
    """SCENES evaluation scenes in one eval_scenes pass (one UNet call a step
    over their CFG batch of 2 x SCENES x 15), then each alone with the same
    generators; one sampler step of both ways on the same inputs, with the
    first UNet module whose output differs, and the batched step against
    its kernel-off twin. Holds them as the SCENES_* comment says; logs
    seconds a scene, launches a scene and peak memory of the batched pass
    and of one at a time. Returns the batched pass's launches with K1's,
    the LayerNorm's and the GEMM's by shape (empty on the CPU). `device`/
    `cfg` let it be rehearsed on the CPU at the tiny config."""
    import torch

    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.pipeline.eval import eval_scenes

    dev = torch.device(device)
    model = model if model is not None else build_model(device, cfg)
    scenes = gso_scenes(model, SCENES, dev)
    images, R, T, f, c, ii, ti = scenes
    gen = lambda n: torch.Generator(device=dev).manual_seed(SEED + 10 + n)
    runs = {}
    for mode in ("batched", "alone"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        timings, outs = [], []
        parts = [list(range(SCENES))] if mode == "batched" else [[n] for n in range(SCENES)]
        for part in parts:
            outs.append(eval_scenes(model, images[part], R[part], T[part], f[part], c[part], ii, ti, 2.5,
                                    num_steps=steps, generators=[gen(n) for n in part], timings=timings))
        out = {k: torch.cat([getattr(o, k) for o in outs]) for k in outs[0]._fields}
        seconds = sum(sum(t.values()) for t in timings)
        runs[mode] = dict(out=out, seconds=seconds, sample=sum(t["sample"] for t in timings),
                          launches=dict(_lib.LAUNCHES), gn_shapes=dict(_lib.GN_SHAPES),
                          shapes={**_lib.GEMM_SHAPES, **_lib.GN_SHAPES, **_lib.LN_SHAPES},
                          peak=torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan"))
    got, want = runs["batched"]["out"], runs["alone"]["out"]
    B, ls = EVAL_TARGETS, model.cfg.latent_size
    check(tuple(got["pred_depth"].shape) == (SCENES, B, ls, ls, 1), f"pred_depth {tuple(got['pred_depth'].shape)}")
    check(all(bool(torch.isfinite(v).all()) for v in got.values()), "non-finite output")
    step, plain_gap = scene_step_gap(model, scenes, steps)
    worst = {}
    for k in got:
        a, b = got[k].float(), want[k].float()
        diff = (a - b).abs()
        top = b.abs().max().item()
        worst[k], mean = diff.max().item(), diff.mean().item()
        if k in SCENE_FIELDS_EXACT:
            ok, rule = worst[k] == 0, "bit-equal"
        else:
            gap = (b[0] - b[1]).abs()
            mix = gap.mean().item()
            ok, rule = mean <= SCENES_MIX_FRACTION * mix, (f"mean held to {SCENES_MIX_FRACTION:g} x mean|scene 0 - "
                                                           f"scene 1| {mix:.3e} (max|scene 0 - scene 1| "
                                                           f"{gap.max().item():.3e}: no max bound)")
        log(f"  {k}: max|batched - alone| {worst[k]:.3e} ({worst[k] / bf16_ulp(torch.tensor(top)).item():.1f} bf16 "
            f"ulps of max|alone| {top:.3e}), mean {mean:.3e}, {(diff == 0).float().mean().item():.2%} of elements "
            f"bit-equal; {rule} -> {'ok' if ok else 'MISS'}")
        check(ok, f"scenes: {k} batched differs from one at a time ({worst[k]:.3e}, mean {mean:.3e})")
    b, a = runs["batched"], runs["alone"]
    counts = {}
    if dev.type == "cuda":
        per = lambda m, key: runs[m]["launches"].get(key, 0)
        check(per("batched", "crossview_two_phase") == SCENES * steps and per("alone", "crossview_two_phase")
              == SCENES * steps, "GridAttn (K4b) did not run once a scene a step")
        check(per("batched", "transformer_block") * SCENES == per("alone", "transformer_block") > 0,
              "the batched pass did not run the UNet's sites once for all scenes")
        check_gn_shapes(b["gn_shapes"], GN_BATCH["scenes"], steps)
        counts = {**b["launches"], **b["shapes"]}
        if profile:
            profile_scene_steps(model, scenes, profile)
    by_kernel = lambda m: ", ".join(f"{k} {v / SCENES:g}" for k, v in sorted(runs[m]["launches"].items()))
    log(f"  launches a scene, batched: {by_kernel('batched')}; one at a time: {by_kernel('alone')}")
    log(f"  scenes: {SCENES} x {B} target views, {steps} steps: batched {b['seconds'] / SCENES:.3f} s/scene "
        f"({b['sample'] / (SCENES * steps):.4f} s/step a scene), one at a time {a['seconds'] / SCENES:.3f} s/scene "
        f"({a['sample'] / (SCENES * steps):.4f}); kernel launches a scene {sum(b['launches'].values()) / SCENES:.1f} "
        f"against {sum(a['launches'].values()) / SCENES:.1f}; peak memory {b['peak']:.2f} against {a['peak']:.2f} "
        f"GiB; one step's gap {step:.3e}, batched with the kernels against without {plain_gap:.3e}; on {card}")
    return dict(counts=counts, worst=worst, step=step, plain_gap=plain_gap)


def scene_step_gap(model, scenes, steps: int) -> tuple:
    """One sampler step (apply_model_cfg_scenes and ddim_step at the
    schedule's first timestep) of the SCENES scenes together against each
    alone, and against the same batched call under the kernel-off switch,
    on the same latents, jitter and noise; the latents held to
    SCENES_STEP_RTOL x max(1, max|reference|) both times. Logs the first
    UNet module (in call order) whose output for a scene differs between
    together and alone. Returns the two max|diff|."""
    import torch

    from mvdfusion_tpu_torch.core.schedule import ddim_step, make_ddim_schedule
    from mvdfusion_tpu_torch.ops import _lib

    images, R, T, f, c, ii, ti = scenes
    cfg, dev = model.cfg, images.device
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    ls, B = cfg.latent_size, ti.shape[0]
    x = torch.randn(SCENES, B, ls, ls, 5, generator=g, device=dev)
    jitter = torch.randn(SCENES, B, ls, ls, cfg.n_pts_per_ray, generator=g, device=dev)
    noise = torch.randn(SCENES, B, ls, ls, 5, generator=g, device=dev)
    ddim = make_ddim_schedule(cfg.timesteps, steps, cfg.linear_start, cfg.linear_end, device=dev)
    t = ddim.timesteps[steps - 1].expand(B)
    seen, calls = {}, []  # module name -> its outputs in call order; the names in first-call order

    def hook(name):
        def record(module, args, out):
            if isinstance(out, torch.Tensor):
                calls.append(name) if name not in seen else None
                seen.setdefault(name, []).append(out.detach())
        return record

    hooks = [m.register_forward_hook(hook(n)) for n, m in model.unet.named_modules() if n]
    with torch.no_grad():
        try:
            prepared = [model.prepare_batch(images[n], R[n], T[n], f[n], c[n], ii, ti)[1:] for n in range(SCENES)]
            cams, in_lat, in_cams, clip_v = zip(*prepared)
            batched = lambda: model.apply_model_cfg_scenes(x, cams, in_lat, in_cams, torch.stack(clip_v), t, 2.5,
                                                           jitter)
            both = batched()
            alone = torch.stack([model.apply_model_cfg(x[n], *prepared[n], t, 2.5, jitter[n])
                                 for n in range(SCENES)])
        finally:
            for h in hooks:
                h.remove()
        _lib.reset_launches()
        with _lib.plain_versions():
            both_plain = batched()
        check(not _lib.LAUNCHES, f"kernels launched under the kernel-off switch: {dict(_lib.LAUNCHES)}")
    for name in calls:  # the batched call's rows [cond of each scene | null of each scene], B rows a scene
        outs = seen[name]
        if len(outs) != 1 + SCENES or outs[0].shape[0] != 2 * SCENES * B:
            continue
        rows = lambda n: [*range(n * B, (n + 1) * B), *range((SCENES + n) * B, (SCENES + n + 1) * B)]
        gap = max((outs[0][rows(n)].float() - outs[1 + n].float()).abs().max().item() for n in range(SCENES))
        if gap > 0:
            log(f"  the first UNet module whose output differs, together against alone: {name} "
                f"{type(model.unet.get_submodule(name)).__name__} {tuple(outs[0].shape)}, max|diff| {gap:.3e}")
            break
    step = lambda eps: ddim_step(ddim, x, eps, steps - 1, noise)[0]
    at = f"latents after one DDIM step (t={int(t[0])}), {SCENES} scenes together"
    together = compare(f"{at} against each alone", step(both), step(alone), SCENES_STEP_RTOL,
                       "the forms phase's one-step rule: bf16 rounding at other points (cuBLAS, cuDNN and K1 "
                       "kernels picked per batch)", cfg.dtype)
    plain = compare(f"{at}, the kernels against the kernel-off switch (CFG batch {2 * SCENES * B})", step(both),
                    step(both_plain), SCENES_STEP_RTOL, "the forms phase's one-step rule: bf16 rounding at other "
                    "points in every kernel of the UNet", cfg.dtype)
    return together, plain


def profile_scene_steps(model, scenes, steps: int) -> None:
    """torch.profiler's count of kernel launches a step a scene: `steps`
    sampler steps of the SCENES scenes batched, then of one scene alone."""
    import torch

    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample_scenes

    images, R, T, f, c, ii, ti = scenes
    with torch.no_grad():
        prepared = [model.prepare_batch(images[n], R[n], T[n], f[n], c[n], ii, ti)[1:] for n in range(SCENES)]
    for n in (SCENES, 1):
        cams, in_lat, in_cams, clip_v = zip(*prepared[:n])
        g = [torch.Generator(device="cuda").manual_seed(SEED + k) for k in range(n)]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ddim_sample_scenes(model, cams, in_lat, in_cams, torch.stack(clip_v), 2.5, num_steps=steps, generators=g,
                               feed_prev_depth=model.cfg.feed_prev_depth)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summarize_profile(prof, wall, steps, f"{n} scene(s) in one sampler pass", "step", top=8)


# ---------------------------------------------------------------- phase 10
LOADER_HEADERS = ("jpeglib.h", "png.h", "zlib.h")  # what native/loader.cc includes, under /usr/include
LOADER_STORED, LOADER_SIZE = 512, 256  # the renders' size and configs/train.yaml's image_size
# native against PIL at the stored size (no resize): pngs within a float32
# rounding of x / 255 (the loader multiplies by 1/255, numpy divides), jpgs
# within one level: the system libjpeg and Pillow's bundled one may round
# the inverse DCT apart
LOADER_PNG_ATOL = 1e-6
LOADER_JPG_ATOL = 1 / 255 + 1e-6


def loader_probe() -> list:
    """Log the host's g++, the loader's headers under /usr/include and
    ldconfig's libjpeg, libpng and libz; return the missing headers."""
    gxx = shutil.which("g++")
    ver = subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout.splitlines()[0] if gxx else "none"
    missing = [h for h in LOADER_HEADERS if not (Path("/usr/include") / h).exists()]
    ld = subprocess.run(["bash", "-c", "ldconfig -p | grep -E 'libjpeg|libpng|libz\\.'"], capture_output=True,
                        text=True).stdout.split("\n")
    log(f"  loader probe: {ver}; /usr/include/{{jpeglib,png,zlib}}.h: "
        + ", ".join(f"{h} {'no' if h in missing else 'yes'}" for h in LOADER_HEADERS))
    log("  loader probe: ldconfig -p: " + ("; ".join(x.strip() for x in ld if x.strip()) or "no libjpeg, libpng, libz"))
    return missing


@contextlib.contextmanager
def pil_route():
    """The port's datasets on their PIL route (the native loader switched off)."""
    from mvdfusion_tpu_torch.data import datasets

    native_batch = datasets._native_batch
    datasets._native_batch = lambda *a, **k: None
    try:
        yield
    finally:
        datasets._native_batch = native_batch


def run_loader(card: str, stored: int = LOADER_STORED, size: int = LOADER_SIZE) -> dict:
    """The native image loader (mvdfusion_tpu_torch/native/, on the host):
    builds loader.cc (a failed build fails the phase), writes a
    TRAIN_SCENES-scene Objaverse tree of the 16 fix_elevation views at
    stored^2 (rgb jpg, 16-bit depth png, mask jpg), reads every scene at
    size^2 through the native route and through PIL in turn, each timed, and
    holds native against PIL at the stored size (LOADER_*_ATOL). Returns
    the build's seconds and the s a scene of each route."""
    import tempfile

    import numpy as np

    from mvdfusion_tpu_torch import native
    from mvdfusion_tpu_torch.data.datasets import Objaverse
    from mvdfusion_tpu_torch.data.rigs import OBJAVERSE_TRAIN_RING

    info = native.build(force=True)
    check(native.available(), f"the native loader built but does not load: {native.reason()}")
    log(f"  g++ built {info['path']} in {info['seconds']:.2f}s")
    with tempfile.TemporaryDirectory() as tmpd:
        root = Path(tmpd)
        t0 = time.perf_counter()
        write_objaverse(root, TRAIN_SCENES, stored, SEED, subset="tiny", views=[int(i) for i in OBJAVERSE_TRAIN_RING])
        log(f"  wrote {TRAIN_SCENES} scenes of {len(OBJAVERSE_TRAIN_RING)} views at {stored}^2 (jpg, 16-bit png, "
            f"jpg mask) in {time.perf_counter() - t0:.2f}s")
        kw = dict(subset="tiny", fix_elevation=True, load_depth=True, load_mask=True)
        times = {}
        for route in ("native", "pil", "native", "pil"):  # in turns: the file cache is warm for both
            ds = Objaverse(str(root), image_size=size, **kw)
            with pil_route() if route == "pil" else contextlib.nullcontext():
                for i in range(len(ds)):
                    t0 = time.perf_counter()
                    scene = ds[i]
                    times.setdefault(route, []).append(time.perf_counter() - t0)
                    check(scene["images"].shape == (16, size, size, 3) and np.isfinite(scene["depths"]).all(),
                          f"{route}: scene {i} {scene['images'].shape}")
        per = {r: sorted(v)[len(v) // 2] for r, v in times.items()}
        log(f"  read at {size}^2 (16 rgb jpgs, 16 depth pngs, 16 mask jpgs a scene): native "
            + ", ".join(f"{t:.4f}" for t in times["native"]) + " s a scene, PIL "
            + ", ".join(f"{t:.4f}" for t in times["pil"]) + f" s a scene; medians {per['native']:.4f} and "
            f"{per['pil']:.4f} ({per['pil'] / per['native']:.2f}x), on the host of {card}")
        ds = Objaverse(str(root), image_size=stored, **kw)
        a = ds[0]
        with pil_route():
            b = ds[0]
        gaps = {k: float(np.abs(a[k] - b[k]).max()) for k in ("images", "depths", "masks")}
        log(f"  native against PIL at {stored}^2: max|diff| " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
            + f" (jpgs within {LOADER_JPG_ATOL:.3e}, pngs within {LOADER_PNG_ATOL:g} x max(1, |x|))")
        check(gaps["images"] <= LOADER_JPG_ATOL, f"rgb jpgs: native against PIL {gaps['images']:.3e}")
        check(bool((np.abs(a["depths"] - b["depths"]) <= LOADER_PNG_ATOL * np.maximum(1, np.abs(b["depths"]))).all()),
              f"depth pngs: native against PIL {gaps['depths']:.3e}")
        check(gaps["masks"] == 0.0, "the masks take PIL on both routes")
    return dict(build_s=info["seconds"], native_s=per["native"], pil_s=per["pil"])


# ---------------------------------------------------------------- phase 11
TRAIN_CONFIG = HERE / "configs" / "train.yaml"
TRAIN_SCENES = 2  # Objaverse-layout scenes the phase writes: no render ships
# the train phase's tolerances (PERF.md): one micro-step under
# train_fuse_mode "model" (K3 at the 32^2 and 16^2 sites, K4 in GridAttn)
# against "never" (their module paths) on the same parameters and draws, bf16
TRAIN_MODE_LOSS_RTOL = 5e-2  # |loss(model) - loss(never)| <= this x |loss(never)|
# per trainable leaf: max|g(model) - g(never)| <= RTOL x max|g(never)| of the
# leaf, or <= FLOOR x the largest max|g(never)| of any leaf (the floor of a
# gradient the structure makes zero or near it: a shift ahead of a
# GroupNorm or a softmax, rounding noise in both modes)
TRAIN_MODE_GRAD_RTOL = 0.25
TRAIN_MODE_GRAD_FLOOR = 1e-2


def write_gso(root: Path, scenes: int, size: int, seed: int) -> None:
    """A GSO-layout directory: `scenes` scene folders of 16 random RGBA pngs
    at size^2 and the subset list test.json."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = [f"scene_{s}" for s in range(scenes)]
    for name in names:
        (root / name).mkdir(parents=True)
        for i in range(16):
            rgba = (rng.uniform(size=(size, size, 4)) * 255).astype(np.uint8)
            rgba[..., 3] = 255
            Image.fromarray(rgba, "RGBA").save(root / name / f"{i:03d}.png")
    (root / "test.json").write_text(json.dumps(names))


def write_objaverse(root: Path, scenes: int, size: int, seed: int, subset: str = "400k", views=range(64)) -> None:
    """An Objaverse-layout tree: subset_list/{subset}_train.json and, for each
    of `scenes` uids, {subset}/{uid}/views/{i:03d}_rgb.jpg, _depth.png (16-bit)
    and _mask.jpg of random content at size^2 for each render i in `views`
    (all 64 by default; fix_elevation reads 40..55)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    names = [f"uid_{s:04d}" for s in range(scenes)]
    (root / "subset_list").mkdir(parents=True)
    (root / "subset_list" / f"{subset}_train.json").write_text(json.dumps(names))
    for name in names:
        d = root / subset / name / "views"
        d.mkdir(parents=True)
        for i in views:
            Image.fromarray((rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)).save(d / f"{i:03d}_rgb.jpg")
            depth = (rng.uniform(size=(size, size)) * 255 * 2).astype(np.uint16)
            Image.fromarray(depth).save(d / f"{i:03d}_depth.png")
            Image.fromarray((rng.uniform(size=(size, size)) > 0.5).astype(np.uint8) * 255).save(d / f"{i:03d}_mask.jpg")


def train_config(tmp: Path, size: int, save_interval: int, objaverse: bool = False) -> Path:
    """configs/train.yaml with its saver writing under `tmp` (a checkpoint
    every save_interval steps, no vis or loss plot) and its dataset on a
    tree under `tmp` at `size`^2: with `objaverse`, its own `objaverse`
    target with only the root moved to tmp/objaverse (write_objaverse);
    else a GSO directory at tmp/gso (write_gso). Model and trainer sections
    as they stand."""
    import yaml

    cfg = yaml.safe_load(TRAIN_CONFIG.read_text())
    if objaverse:
        cfg["dataset"]["params"].update(root=str(tmp / "objaverse"), image_size=size)
    else:
        cfg["dataset"] = {"target": "gso", "params": {"root": str(tmp / "gso"), "subset": "test", "image_size": size}}
    cfg["saver"] = {"exp_dir": str(tmp / "exp") + "/", "print_interval": 1, "save_interval": save_interval,
                    "vis_interval": 0, "loss_interval": 10**9}
    path = tmp / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def function_cases(rnd, dev, dt):
    """Each kernel entry point that is a torch.autograd.Function, at a shape
    of the train step or the flagship in `dt`: (name, entry, plain, inputs,
    atomics). `atomics`: the plain version's backward sums with atomics
    (index_add in the gather, cuDNN's weight gradient) and so is not
    bit-reproducible."""
    from mvdfusion_tpu_torch.ops import attention as K2
    from mvdfusion_tpu_torch.ops import block as K3
    from mvdfusion_tpu_torch.ops import conv3x3 as K8
    from mvdfusion_tpu_torch.ops import crossview as K4
    from mvdfusion_tpu_torch.ops import groupnorm as GN

    gn = lambda route: (lambda x, w, b: GN.group_norm_act(x, w, b, 32, 1e-5, "silu", route))
    gn_plain = lambda f: (lambda x, w, b: f(x, w, b, 32, 1e-5, "silu"))
    cases = [
        ("K1 group_norm_act (5, 1024, 320)", gn("k1"), gn_plain(GN.group_norm_plain),
         [rnd(5, 1024, 320, dt=dt), 1 + rnd(320, std=0.1), rnd(320, std=0.1)], False),
        ("K7 group_norm_act (6, 65536, 128)", gn("k7"), gn_plain(GN.group_norm_tiled_plain),
         [rnd(6, 65536, 128, dt=dt), 1 + rnd(128, std=0.1), rnd(128, std=0.1)], False),
        ("K2 fused_attention (5, 1024, 8, 40)", lambda q, k, v: K2.fused_attention(q, k, v, 40**-0.5),
         lambda q, k, v: K2.attention_plain(q, k, v, 40**-0.5), [rnd(5, 1024, 8, 40, dt=dt) for _ in range(3)],
         False),
    ]
    for form, (B, N, C) in (("split", (5, 1024, 320)), ("single", (5, 1024, 320)), ("big", (5, 64, 1280))):
        x, a2, w = site_inputs(rnd, B, N, C, dt, a2_map=C == 640)
        plain = K3.transformer_block_big_plain if form == "big" else K3.transformer_block_plain
        cases.append((f"K{ {'split': 3, 'single': 5, 'big': 6}[form]} transformer_block {form} ({B}, {N}, {C})",
                      lambda x, a2, *t, form=form: K3.transformer_block(x, a2, K3.BlockWeights(*t), 8, form),
                      lambda x, a2, *t, plain=plain: plain(x, a2, K3.BlockWeights(*t), 8), [x, a2, *w], False))
    for V, name in ((8, "K4 crossview_aggregate V=8"), (15, "K4b crossview_aggregate V=15")):
        args, *_ = cv_inputs(K4, rnd, dev, V, 32, 256, DIT_LAYERS, 8, 768, dt)
        xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs = args
        L = len(w.qkv_w)
        flat = K4._flat_weights(kg, w)
        plain = K4.crossview_two_phase_plain if K4.crossview_route(V, 32, 32, 256, dt) == "two_phase" else K4.crossview_plain
        cases.append((name, lambda *t, L=L, heads=heads, freqs=freqs: K4.crossview_aggregate(
                          *t[:6], *K4._unflat_weights(t[6:], L, 0), heads, freqs),
                      lambda *t, L=L, heads=heads, freqs=freqs, plain=plain: plain(
                          *t[:6], *K4._unflat_weights(t[6:], L, 0), heads, freqs),
                      [xy, pts, centers, mask, b_acc, maps_p, *flat], True))
    Cin = Cout = 256
    cases.append(("K8 gn_silu_conv3x3 (1, 64, 64, 256)", K8.gn_silu_conv3x3, K8.conv3x3_plain,
                  [rnd(1, 64, 64, Cin, dt=dt), 1 + rnd(1, Cin, std=0.1), rnd(1, Cin, std=0.1),
                   rnd(Cout, Cin, 3, 3, std=(9 * Cin) ** -0.5, dt=dt), rnd(Cout, std=0.1), rnd(1, Cout, std=0.1),
                   rnd(1, 64, 64, Cout, dt=dt)], True))
    return cases


def function_grad_checks(dev) -> None:
    """Each Function's input gradients at a flagship or train-step shape in
    bf16 (its forward the kernel, its backward the plain version's autograd
    on the saved inputs) against the plain version's own autograd on the
    same inputs and output gradient: bit-equal, or within 1 bf16 ulp of
    max|grad| where the plain backward sums with atomics."""
    import torch

    from mvdfusion_tpu_torch.ops import _lib

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rnd = lambda *s, std=1.0, dt=torch.float32: (torch.randn(*s, generator=gen, device=dev) * std).to(dt)
    for name, entry, plain, inputs, atomics in function_cases(rnd, dev, torch.bfloat16):
        leaves = [t.detach().requires_grad_(True) if t.is_floating_point() else t for t in inputs]
        _lib.reset_launches()
        out = entry(*leaves)
        launched = sum(_lib.LAUNCHES.values())
        check(out.grad_fn is not None and launched > 0, f"{name}: no graph or no launch ({launched})")
        g = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        wrt = [t for t in leaves if t.requires_grad]
        got = torch.autograd.grad(out, wrt, g)
        want = torch.autograd.grad(plain(*leaves), wrt, g)
        again = torch.autograd.grad(plain(*leaves), wrt, g) if atomics else want
        ulps = lambda xs, ys: [((a.float() - b.float()).abs().max() / bf16_ulp(b.float().abs().max())).item()
                               for a, b in zip(xs, ys)]
        per, own = ulps(got, want), ulps(again, want)
        worst, equal = max(per), all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        if atomics:
            top = sorted(range(len(per)), key=lambda i: -per[i])[:4]
            log(f"  {name}: by input (index: Function vs plain, plain vs itself, in bf16 ulp of max|grad|, "
                f"max|grad|): " + "; ".join(f"{i}: {per[i]:.3f}, {own[i]:.3f}, {want[i].abs().max().item():.3e}"
                                            for i in top))
        ok = equal if not atomics else worst <= 1.0
        log(f"  {name}: {len(wrt)} input gradients against the plain version's autograd: "
            f"{'bit-equal' if equal else f'at most {worst:.3f} bf16 ulp of max|grad|'} "
            f"(tolerance: {'1 ulp, its backward sums with atomics' if atomics else 'bit-equal'}) -> "
            f"{'ok' if ok else 'MISS'}")
        check(ok, f"{name}: gradients disagree with the plain version's")


def train_mode_gap(model, dataset, dev) -> dict:
    """One micro-step (one scene, 5 targets) under train_fuse_mode "model"
    (fuse_mode "auto": the sites' and GridAttn's kernels) and "never" on the
    same parameters and draws: the loss's relative gap and each trainable
    leaf's max|diff| against TRAIN_MODE_*; checks finiteness, and the
    launches of K3 and K4 under "model"."""
    import dataclasses

    import numpy as np
    import torch

    from mvdfusion_tpu_torch.ops import _lib

    sc = dataset[0]
    scene = [torch.as_tensor(np.asarray(sc[k], np.float32), device=dev) for k in ("images", "R", "T", "f", "c")]
    scene += [torch.tensor([0], device=dev), torch.arange(1, 6, device=dev)]
    draws = model.loss_draws(5, dev, torch.Generator(device=dev).manual_seed(SEED + 5))
    cfg, out = model.cfg, {}
    try:
        for mode in ("never", "auto"):
            model.cfg = dataclasses.replace(cfg, fuse_mode=mode)
            model.zero_grad(set_to_none=True)
            _lib.reset_launches()
            loss = model.p_losses(*scene, **draws)
            loss.backward()
            out[mode] = (loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                       if p.grad is not None}, dict(_lib.LAUNCHES))
            model.zero_grad(set_to_none=True)
    finally:
        model.cfg = cfg
    (ln, gn, cn), (lm, gm, cm) = out["never"], out["auto"]
    check(math.isfinite(ln) and math.isfinite(lm), f"non-finite loss {ln} {lm}")
    check(all(bool(torch.isfinite(g).all()) for g in gn.values()), "non-finite gradients (never)")
    check(all(bool(torch.isfinite(g).all()) for g in gm.values()), "non-finite gradients (model)")
    check(set(gn) == set(gm), "the two modes' gradients reach different parameters")
    gap = abs(lm - ln) / abs(ln)
    top = max(g.float().abs().max().item() for g in gn.values())
    ratios, over = {}, []
    for n in gn:
        diff = (gm[n].float() - gn[n].float()).abs().max().item()
        scale = gn[n].float().abs().max().item()
        ratios[n] = diff / max(scale, 1e-30)
        if diff > max(TRAIN_MODE_GRAD_RTOL * scale, TRAIN_MODE_GRAD_FLOOR * top):
            over.append(n)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])
    log(f"  micro-step under \"model\" against \"never\": loss {lm:.6f} vs {ln:.6f}, relative gap {gap:.3e} "
        f"(tolerance {TRAIN_MODE_LOSS_RTOL:g}); {len(ratios)} trainable leaves, max|diff| / max|g(never)| median "
        f"{sorted(ratios.values())[len(ratios) // 2]:.3e}, largest " + ", ".join(f"{n} {r:.3e}" for n, r in worst[:4])
        + f" (tolerance {TRAIN_MODE_GRAD_RTOL:g} x max|g(never)| or {TRAIN_MODE_GRAD_FLOOR:g} x {top:.3e}, the largest "
        f"max|g(never)|, each; {len(over)} over)")
    log(f"  launches under \"never\" {cn}; under \"model\" {cm}")
    if dev.type == "cuda":
        check(cn.get("transformer_block", 0) == 0 and cn.get("crossview", 0) == 0, "\"never\" launched a site kernel")
        check(cm.get("transformer_block", 0) > 0 and cm.get("crossview", 0) > 0, "\"model\" launched no K3 or K4")
    check(gap <= TRAIN_MODE_LOSS_RTOL, f"loss gap {gap:.3e} between the modes")
    check(not over, f"{len(over)} leaves' gradients differ between the modes past {TRAIN_MODE_GRAD_RTOL}: {over[:5]}")
    return dict(gap=gap, worst=worst[0])


def profile_train(model, state, tc, dataset, scenes: int, calls: int) -> None:
    """torch.profiler over `calls` train steps of `scenes` scenes (the
    dataset's scenes in turn, views 0 -> 1..5), by kernel."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvdfusion_tpu_torch.pipeline import trainer

    dev = torch.device("cuda")
    sc = [dataset[i % len(dataset)] for i in range(scenes)]
    batch = {k: torch.as_tensor(np.stack([np.asarray(s[k], np.float32) for s in sc]), device=dev)
             for k in ("images", "R", "T", "f", "c")}
    batch["input_idx"] = torch.zeros(scenes, 1, dtype=torch.long, device=dev)
    batch["target_idx"] = torch.arange(1, 6, device=dev).repeat(scenes, 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    trainer.train_step(model, state, batch, tc, generator=g)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            trainer.train_step(model, state, batch, tc, generator=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize_profile(prof, wall, calls, f"train, {scenes} scenes a call", "call", top=24)


def run_train(card: str, steps: int = 1, device: str = "cuda", tiny: bool = False, profile: int = 0) -> dict:
    """The train path through cli/train.py's main at configs/train.yaml's
    model (bf16, random weights from SEED; `tiny`: the tiny config, a CPU
    rehearsal) and trainer section (5 targets, scenes_per_chip 4,
    grad_accum_step 4, finetune_unet) on a 2-scene GSO-layout directory of
    random 256^2 images it writes to a temporary directory: `steps`
    optimizer steps with a checkpoint at the end, then a one-step resume.
    Checks the frozen parameters bit-equal after the steps, K1 and K2
    launched inside them, the resume, then the kernels-on/off gaps
    (train_mode_gap, tools/numerics_check.py with its launches under the
    switch) and each Function's gradients (on the card). `profile`: trace
    that many more calls on the resumed model by kernel (on the card)."""
    import gc
    import tempfile

    import torch

    from mvdfusion_tpu_torch import native
    from mvdfusion_tpu_torch.cli import train as cli
    from mvdfusion_tpu_torch.core.config import build_dataset, build_train_config, load_yaml
    from mvdfusion_tpu_torch.data.datasets import Objaverse
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.pipeline import trainer
    from mvdfusion_tpu_torch.tools import numerics_check

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    init0, step0 = trainer.init_train_state, trainer.train_step
    calls, frozen, loads = [], {}, []
    item0 = Objaverse.__getitem__

    def load_hook(self, index):
        t0 = time.perf_counter()
        out = item0(self, index)
        loads.append(time.perf_counter() - t0)
        return out

    def init_hook(model, tc):
        state = init0(model, tc)
        if not frozen:
            frozen.update({n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad})
        return state

    def step_hook(*a, **kw):
        sync()
        t0 = time.perf_counter()
        loss = step0(*a, **kw)
        value = float(loss)
        calls.append((time.perf_counter() - t0, value))
        return loss

    with tempfile.TemporaryDirectory() as tmpd:
        tmp = Path(tmpd)
        size = 64 if tiny else 256
        raw = load_yaml(str(TRAIN_CONFIG))
        check(raw["dataset"]["target"] == "objaverse", f"configs/train.yaml's dataset is {raw['dataset']['target']!r}")
        write_objaverse(tmp / "objaverse", TRAIN_SCENES, size, SEED, subset=raw["dataset"]["params"]["subset"])
        tc = build_train_config(raw)
        k = tc.grad_accum_step
        spc = int(raw["trainer"]["scenes_per_chip"])
        cfgp = train_config(tmp, size, k * steps, objaverse=True)
        argv = ["-c", str(cfgp), "--device", device, "--seed", str(SEED)] + (["--tiny"] if tiny else [])
        trainer.init_train_state, trainer.train_step = init_hook, step_hook
        Objaverse.__getitem__ = load_hook
        try:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _lib.reset_launches()
            t0 = time.perf_counter()
            model, state = cli.main(argv + ["--max-steps", str(k * steps)])
            run_s = time.perf_counter() - t0
            counts = dict(_lib.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
            check(state.step == k * steps and state.opt_state["count"] == steps,
                  f"{state.step} calls, {state.opt_state['count']} optimizer steps")
            check(all(math.isfinite(v) for _, v in calls), f"non-finite loss {calls}")
            params = dict(model.named_parameters())
            check(len(frozen) > 0 and all(torch.equal(params[n], t) for n, t in frozen.items()),
                  "a frozen parameter moved")
            ckpt = tmp / "exp" / "ckpt"
            check((ckpt / "latest").read_text() == f"step_{k * steps:08d}", "no checkpoint at the last step")
            per_call = [s for s, _ in calls]
            opt_s = sum(per_call[-k:])  # the last optimizer step's calls (with steps=1, the first call's warm-up too)
            steady = sorted(per_call[1:])[len(per_call[1:]) // 2] if len(per_call) > 1 else float("nan")
            log(f"  {k * steps} calls ({steps} optimizer steps of {k} calls, {spc} scenes a call, 5 targets a "
                f"scene): s per call " + ", ".join(f"{s:.3f}" for s in per_call) + f"; losses "
                + ", ".join(f"{v:.4f}" for _, v in calls))
            log(f"  train: {opt_s:.3f} s per optimizer step (the last), {k * spc / opt_s:.3f} scenes/s; after the first "
                f"call {steady:.3f} s a call (median), {spc / steady:.3f} scenes/s; peak memory "
                f"{peak:.2f} GiB (max_memory_allocated), main {run_s:.1f}s with the model's build and the "
                f"checkpoint ({sum(f.stat().st_size for f in ckpt.iterdir()) / 2**30:.2f} GiB), on {card}")
            # the loader runs in the prefetch thread beside the steps: its seconds a
            # batch (spc scenes) against the seconds a call say what share it could take
            per_batch = sorted(loads)[len(loads) // 2] * spc
            route = "the native loader (native/loader.cc)" if native.available() else "PIL"
            log(f"  loader (data/datasets.py::Objaverse, {size}^2 jpgs through {route}): {len(loads)} scenes read, "
                f"{', '.join(f'{t:.3f}' for t in loads)} s a scene; {per_batch:.3f} s a batch of {spc} scenes (the "
                f"median scene) against {steady:.3f} s a call after the first ({per_batch / steady:.1%} of a call)")
            log(f"  launches in the run: {counts}")
            if dev.type == "cuda":
                check(counts.get("groupnorm", 0) > 0 and counts.get("attention", 0) > 0,
                      "K1 or K2 launched no time in the train step")
                check(counts.get("transformer_block", 0) == 0 and counts.get("crossview", 0) == 0,
                      "the default step (\"never\") launched a site kernel")
            del model, state, params
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            calls.clear()
            model, state = cli.main(argv + ["--max-steps", "1"])
            check(state.step == k * steps + 1 and len(calls) == 1 and math.isfinite(calls[0][1]),
                  f"resume: at call {state.step}")
            params = dict(model.named_parameters())
            check(all(torch.equal(params[n], t) for n, t in frozen.items()), "a frozen parameter moved on resume")
            log(f"  resumed from step {k * steps}: one call {calls[0][0]:.3f}s, loss {calls[0][1]:.4f}")
        finally:
            trainer.init_train_state, trainer.train_step = init0, step0
            Objaverse.__getitem__ = item0
        dataset = build_dataset(load_yaml(str(cfgp)))
        check(isinstance(dataset, Objaverse), f"configs/train.yaml's target built {type(dataset).__name__}")
        if profile and dev.type == "cuda":
            profile_train(model, state, tc, dataset, spc, profile)
        gap = train_mode_gap(model, dataset, dev)
    model.eval()
    res = numerics_check.compare(model)
    log(f"  apply_model_cfg kernels against MVDF_DISABLE_PALLAS=1 (tools/numerics_check.py, 8 targets): max|diff| "
        f"{res['max_diff']:.5f}, mean|diff| {res['mean_diff']:.6f}, max|plain| {res['scale']:.3f}, tolerance "
        f"{numerics_check.TOLERANCE:g} x max(1, max|plain|) = {res['bound']:.4f}; launches under the switch: "
        f"{res['plain_launches']}")
    check(res["finite"] and res["plain_launches"] == 0, "the switch left a kernel launch or a non-finite output")
    check(res["ok"], f"kernels against their plain versions: max|diff| {res['max_diff']:.5f} > {res['bound']:.4f}")
    if dev.type == "cuda":
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
        function_grad_checks(dev)
    return dict(counts=counts, gap=gap, numerics=res, loader_s=loads)


# ---------------------------------------------------------------- phase 12
DP_RANKS = 2  # ranks sharing the card over gloo (NCCL refuses two ranks on one device)
DP_VIEWS = 16  # the GSO rig's views; 1 input and configs/train.yaml's 5 targets drawn from them
# two ranks, one scene each, against one rank with both, on the same draws.
# The loss (the fp32 mean of the two scenes' losses on both sides) within
# DP_LOSS_RTOL of its value: about 8 fp32 ulps; measured bit-equal on an
# H100 (PERF.md). The gradient the optimizer reads (the fp32 mean of the
# two scenes' gradients) within DP_GRAD_RTOL x its max: the backward
# kernels that add with atomics round apart; measured 1.9e-6 and 7.6e-6 of
# max|g| 0.3994 (4.8e-6 and 1.9e-5 of it), so 5x room over the larger. A
# half-batch or unreduced step moves the gradient by the two scenes' gap,
# O(max|g|). The masters element by element: AdamW's first step moves a
# master by lr x (g/(|g| + eps) + wd x master) (configs/train.yaml sets no
# clip), so the two steps may differ
# by lr x |g/(|g|+eps) - g'/(|g'|+eps)| for the two gradients g, g' the
# element read (largest where |g| is near eps), plus the update's roundings
# (DP_UPDATE_ULPS units of 2^-24 of lr) and the subtraction's (1 ulp of the
# master); any other difference (another lr, step count, gradient) shows.
DP_LOSS_RTOL = 1e-6
DP_GRAD_RTOL = 1e-4
DP_UPDATE_ULPS = 8


def _checksum(t) -> int:
    """An exact fingerprint of a tensor's bits (their int32 words summed, each
    weighted by its position modulo a prime)."""
    import torch

    words = t.detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
    weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
    return int((words * weights).sum())


def train_model(dev, tiny: bool):
    """configs/train.yaml's model (bf16 towers; `tiny`: the tiny config) on
    `dev`: one a process serves every step of the dp and tp phases, as
    dp_step draws its weights from SEED anew."""
    from mvdfusion_tpu_torch.core.config import build_model_config, load_yaml
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion

    mcfg = build_model_config(load_yaml(str(TRAIN_CONFIG)))
    return ViewFusion(mcfg.tiny() if tiny else mcfg, device=dev)


def dp_step(dev, model, mine, reduce: bool, mesh=None, keep: bool = False, against=None, gap=None) -> dict:
    """One train_step of the dp and tp phases on `model` (train_model), its
    weights drawn from SEED anew, configs/train.yaml's trainer section at
    grad_accum_step 1; the scenes at positions `mine` of DP_RANKS scenes of
    random images on the GSO rig, each with a view split and p_losses draws
    keyed on its position (as cli/train.py keys them). With `reduce` the
    trainer averages over the process group, its all-reduces timed;
    without, the step is one rank's alone. `mesh`: the model placed on it
    (parallel.shard_params_; a split model serves no later step), the
    gradient and masters gathered whole, and whether gather_params's whole
    compute copies are the whole masters cast. Returns the loss, the
    fingerprints of the gradient the optimizer read and of the trainable
    masters after the step, with host copies of both where `keep`, the
    all-reduces, the step's seconds and its launches; given a run
    `against` (host copies), also gap(this run with its gradient and
    masters on the device, against), so that the run compared needs no
    host copy."""
    import dataclasses

    import numpy as np
    import torch

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.core.config import build_train_config, load_yaml
    from mvdfusion_tpu_torch.data.rigs import AZIMUTHS_16, ELEVATIONS_16, fixed_rig
    from mvdfusion_tpu_torch.nn.viewfusion import randomize_
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.parallel.mesh import gather_tensor
    from mvdfusion_tpu_torch.pipeline import trainer

    raw = load_yaml(str(TRAIN_CONFIG))
    mcfg = model.cfg
    tc = dataclasses.replace(build_train_config(raw), grad_accum_step=1)
    n_targets = int(raw["trainer"]["train_batch_size"])
    IMG = mcfg.latent_size * 2 ** (len(mcfg.vae_ch_mult) - 1)
    rng = np.random.default_rng(SEED)
    images = rng.uniform(size=(DP_RANKS, DP_VIEWS, IMG, IMG, 3)).astype(np.float32)
    perms = [rng.permutation(DP_VIEWS) for _ in range(DP_RANKS)]
    R, T, f, c = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)
    on = lambda a: torch.as_tensor(np.stack(a), device=dev)
    n = len(mine)
    batch = dict(images=on([images[p] for p in mine]), R=on([R] * n), T=on([T] * n), f=on([f] * n),
                 c=on([c] * n), input_idx=on([perms[p][:1] for p in mine]),
                 target_idx=on([perms[p][1 : 1 + n_targets] for p in mine]))
    with torch.no_grad():  # the parameters as train_model built them (init_train_state cast them to compute dtypes)
        for p in model.parameters():
            p.data, p.grad = p.data.float(), None
    randomize_(model, seed=SEED)
    model.mesh = None
    if mesh is not None:
        parallel.shard_params_(model, mesh)
    state = trainer.init_train_state(model, tc)
    draws = [model.loss_draws(n_targets, dev, torch.Generator(device=dev).manual_seed(SEED + 100 + p)) for p in mine]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    reduced, seen = [], []
    reduce0, update0 = parallel.all_reduce_mean_, trainer._optimizer_update

    def timed_reduce(tensors, *a, **kw):
        tensors = list(tensors)
        axis = a[0] if a else kw.get("axis")
        if axis is not None and axis.size == 1:  # an axis of one rank: nothing moves
            return reduce0(tensors, *a, **kw)
        sync()
        t0 = time.perf_counter()
        reduce0(tensors, *a, **kw)
        sync()
        reduced.append(dict(bytes=sum(t.nbytes for t in tensors), tensors=len(tensors), s=time.perf_counter() - t0))

    def spy(model, state, tc, grads):
        whole = {n: gather_tensor(g, state.splits.get(n)) for n, g in grads.items()}
        held = {n: g.clone() for n, g in whole.items()} if keep or against is not None else None
        seen.append((list(whole), held, [_checksum(g) for g in whole.values()]))
        return update0(model, state, tc, grads)

    parallel.all_reduce_mean_ = timed_reduce if reduce else (lambda tensors, *a, **kw: None)
    trainer._optimizer_update = spy
    _lib.reset_launches()
    try:
        sync()
        t0 = time.perf_counter()
        loss = trainer.train_step(model, state, batch, tc, draws=draws)
        sync()
        step_s = time.perf_counter() - t0
    finally:
        parallel.all_reduce_mean_, trainer._optimizer_update = reduce0, update0
    counts = dict(_lib.LAUNCHES)
    names, grads, prints = seen[0]
    masters = {k: gather_tensor(state.params[k], state.splits.get(k)) for k in names}
    prints += [_checksum(m) for m in masters.values()]
    out = dict(loss=float(loss), prints=prints, reduces=reduced, step_s=step_s, lr=trainer.learning_rate(tc, 0),
               counts=counts, trainable=len(names), numel=sum(m.numel() for m in masters.values()))
    if mesh is not None:  # the whole compute copies against the whole masters, cast
        copies = parallel.gather_params(model, mesh)
        out["copies_are_masters"] = all(torch.equal(copies[k], m.to(copies[k].dtype)) for k, m in masters.items())
        del copies
    if against is not None:
        out["gap"] = gap(dict(out, grads=grads, masters=masters), against)
    if keep:  # host copies (two ranks share the card)
        out.update(grads={k: g.to("cpu", copy=True) for k, g in grads.items()},
                   masters={k: m.to("cpu", copy=True) for k, m in masters.items()})
    return out


def dp_gap(got: dict, ref: dict) -> dict:
    """The dp step (dp_step, one scene a rank, averaged over the ranks)
    against rank 0's step alone on both scenes: the gradient's and the
    masters' max|diff|, their bit-equal shares, and the masters' largest
    share of the gap the two gradients explain (the DP_* comment)."""
    import torch

    from mvdfusion_tpu_torch.pipeline import trainer

    g_err = g_top = m_err = m_ratio = 0.0
    g_same = m_same = numel = 0
    lr, eps = got["lr"], trainer._EPS
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for k, g in got["grads"].items():
        g, rg, gm, rm = (t.to(dev) for t in (g, ref["grads"][k], got["masters"][k], ref["masters"][k]))
        g_err = max(g_err, (g - rg).abs().max().item())
        g_top = max(g_top, rg.abs().max().item())
        m_err = max(m_err, (gm - rm).abs().max().item())
        g_same += int((g == rg).sum())
        apart = gm != rm
        m_same += g.numel() - int(apart.sum())
        numel += g.numel()
        if apart.any():
            a, b, w = g[apart].double(), rg[apart].double(), rm[apart]
            explained = lr * (a / (a.abs() + eps) - b / (b.abs() + eps)).abs()
            ulp = (torch.nextafter(w.abs(), torch.tensor(float("inf"), device=dev)) - w.abs()).double()
            allow = explained + lr * DP_UPDATE_ULPS * 2.0**-24 + ulp
            m_ratio = max(m_ratio, ((gm[apart] - w).double().abs() / allow).max().item())
    return dict(loss_one=ref["loss"], step_s_one=ref["step_s"], grad_err=g_err, grad_top=g_top, master_err=m_err,
                master_ratio=m_ratio, grad_same=g_same / numel, master_same=m_same / numel)


def nccl_rank(numel: int, out: str) -> None:
    """A rank at world size 1 on the card: init_distributed takes NCCL (one
    local rank, one card); all_reduce_mean_ of `numel` fp32 elements in
    tensors of the site GEMM's (1280, 5120) size, timed and held bit-equal
    (a mean over one rank); writes `out` (JSON)."""
    import torch
    import torch.distributed as dist

    from mvdfusion_tpu_torch import parallel

    dev = parallel.init_distributed("cuda")
    sizes = [1280 * 5120] * (numel // (1280 * 5120)) + [numel % (1280 * 5120)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    tensors = [torch.randn(n, generator=g, device=dev) for n in sizes if n]
    want = [t.clone() for t in tensors]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parallel.all_reduce_mean_(tensors)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with open(out, "w") as fp:
        json.dump(dict(backend=dist.get_backend(), bytes=4 * numel, tensors=len(tensors), s=times,
                       equal=all(torch.equal(a, b) for a, b in zip(tensors, want))), fp)


def run_dp(card: str, device: str = "cuda", tiny: bool = False, res=None) -> dict:
    """The dp phase: DP_RANKS ranks with one scene each (gloo: they share the
    card) against rank 0 alone with both (`res`: run_ranks's "dp", else
    run_ranks for the dp part alone); holds the loss, the gradient and the
    masters of the first to the second (DP_* tolerances) and the ranks to
    each other (bit-equal). On the card, then one rank at world size 1
    (NCCL: its init and an all-reduce of the accumulator's bytes run there).
    `device`/`tiny` let it be rehearsed on the CPU (gloo, no NCCL rank)."""
    import tempfile

    from mvdfusion_tpu_torch import parallel

    if res is None:
        res = run_ranks(device, tiny, ("dp",))["dp"]
    if device == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            parallel.spawn(nccl_rank, 1, (res["numel"], os.path.join(tmp, "nccl.json")))
            res["nccl"] = json.loads((Path(tmp) / "nccl.json").read_text())
    for r in res["reduces"]:
        log(f"  {DP_RANKS} ranks ({res['backend']}): all-reduce of {r['tensors']} tensors, {r['bytes']} bytes "
            f"({r['bytes'] / 2**30:.3f} GiB) in {r['s']:.4f} s ({r['bytes'] / max(r['s'], 1e-9) / 1e9:.2f} GB/s), "
            f"on {card}")
    log(f"  {DP_RANKS} ranks: train_step {res['step_s']:.3f} s (1 scene a rank, the first call), loss "
        f"{res['loss']:.6f}, peak memory {res['peak_gib']:.2f} GiB a rank, {res['trainable']} trainable leaves "
        f"({res['numel']} elements); ranks bit-equal: {res['ranks_agree']}; rank 0 alone on both scenes: "
        f"{res['step_s_one']:.3f} s, on {card}")
    loss_gap = abs(res["loss"] - res["loss_one"]) / abs(res["loss_one"])
    log(f"  {DP_RANKS} ranks against one rank with both scenes: loss {res['loss']:.6f} against {res['loss_one']:.6f} "
        f"(gap {loss_gap:.3e}, tolerance {DP_LOSS_RTOL:g}); gradient max|diff| {res['grad_err']:.3e} against "
        f"{DP_GRAD_RTOL:g} x max|g| {res['grad_top']:.3e} = {DP_GRAD_RTOL * res['grad_top']:.3e}, "
        f"{res['grad_same']:.4%} bit-equal; masters max|diff| {res['master_err']:.3e}, at most "
        f"{res['master_ratio']:.3f} of the gap the two gradients and the roundings explain (lr {res['lr']:g}), "
        f"{res['master_same']:.4%} bit-equal")
    check(res["backend"] == "gloo", f"{DP_RANKS} ranks on one device took {res['backend']}, not gloo")
    check(res["ranks_agree"], "the ranks' gradients or masters differ after the step")
    check(loss_gap <= DP_LOSS_RTOL, f"dp: the loss differs from one rank's ({loss_gap:.3e})")
    check(res["grad_top"] > 0 and res["grad_err"] <= DP_GRAD_RTOL * res["grad_top"],
          f"dp: the gradient differs ({res['grad_err']:.3e}, max|g| {res['grad_top']:.3e})")
    check(res["master_ratio"] <= 1, f"dp: the masters differ more than the gradients explain ({res['master_err']:.3e}, "
                                    f"{res['master_ratio']:.3f} of the gap allowed)")
    if "nccl" in res:
        n = res["nccl"]
        log(f"  world size 1 ({n['backend']}): all-reduce of {n['tensors']} tensors, {n['bytes']} bytes in "
            + ", ".join(f"{t:.4f}" for t in n["s"]) + f" s; the mean of one rank bit-equal: {n['equal']}; on {card}")
        check(n["backend"] == "nccl" and n["equal"], f"NCCL at world size 1: {n}")
    return res


# ---------------------------------------------------------------- phase 13
TP_RANKS = 2  # ranks sharing the card over gloo
TP_STEPS = 2  # DDIM steps of the tp = 2 request
# Rules, derived before the first run on the card. The split model computes
# the function of the whole one; what moves is where bf16 rounds: a row
# layer sums fp32 partials over the ranks then rounds once (the whole layer
# rounds cuBLAS's sum once), a split conv runs cuDNN at half the output
# features, K2 runs at half the heads. Each such rounding may go the other
# way once, as the kernels against their plain versions do, so the
# sampler's first step (apply_model_cfg, then ddim_step) is held as the
# forms and scenes phases hold one: the latents within TP_STEP_RTOL x
# max(1, max|tp = 1|), logged beside the tp = 1 step against itself under
# the kernel-off switch (the noise scale); the VAE decode of the switched
# route as the vae phase holds its routes, 3e-2 x max(1, max|tp = 1|). The
# train steps (configs/train.yaml's model, bf16, one scene, the same draws)
# against rank 0's step alone: the loss within TP_LOSS_RTOL of its value (a
# mean of squared noise predictions that differ by bf16 roundings); each
# trainable leaf's gradient (the one the optimizer reads, gathered whole)
# within TP_LEAF_RTOL x that leaf's own max|g|, so that a split fault confined to
# one subtree (a missing all-reduce) shows whatever the rest of the model's
# gradients are; a leaf's max|g| counts as at least TP_LEAF_FLOOR x the
# model's, since a leaf the architecture all but zeroes (a per-channel bias
# that a GroupNorm of one channel a group takes out, as in the tiny config)
# reads rounding noise on both sides; and each master within the gap its two gradients explain
# through AdamW's first step (the dp phase's rule, DP_*: it reads AdamW's
# sign at gradients near zero, the gradient rule reads the split). The sp
# step differs from one rank's by the UNet's batch (3 and 2 views against
# 5: cuBLAS and cuDNN pick kernels per batch, as the scenes phase found) and
# the VAE encode's (1 + 3 and 1 + 2 images against 1 + 5): the same rules.
TP_STEP_RTOL = 3e-2
TP_VAE_RTOL = 3e-2
# Set from the readings on an H100 (PERF.md section 6): the loss gap 5.355e-4
# (tp = 2) and 1.547e-4 (sp = 2), the largest leaf 2.339e-2 (tp) and
# 2.608e-2 (sp), each limit about 3x the larger reading.
TP_LOSS_RTOL = 1.5e-3
TP_LEAF_RTOL = 8e-2
TP_LEAF_FLOOR = 1e-3
# The masters' rule is the dp phase's, lr |g/(|g|+eps) - g'/(|g'|+eps)| +
# the update's roundings + the subtractions' roundings, both counted on
# both sides: each side's u = (mu/c1)/(sqrt(nu/c2)+eps) + wd master, times
# lr, rounds about 8.5 times in fp32 (mu, nu's two, the divisions, the
# sqrt, + eps, + wd master, x lr), so two sides differ by up to 17 x 2^-24
# lr where their gradients agree (DP_UPDATE_ULPS' 8 counts one side: the dp
# phase's two ranks read bit-equal gradients); each side's master rounds to
# half an ulp of its own value, which differ where the two straddle a power
# of two (the dp rule's 1 ulp of the one-rank master assumes one binade).
TP_UPDATE_ULPS = 18
TP_KERNELS = {"groupnorm": "K1", "attention": "K2", "transformer_block": "K3", "crossview": "K4",
              "groupnorm_tiled": "K7"}
TP_SWITCHED = {"transformer_block_single": "K5", "transformer_block_big": "K6", "conv3x3": "K8"}


def tp_sample(dev, tiny: bool, mesh=None) -> dict:
    """The tp phase's request on the flagship model (bf16, random weights
    from SEED; `tiny`: the tiny config), split on `mesh` where given:
    prepare_batch of 9 random 256^2 images from a seed, the sampler's first
    step on fixed noise (the latents after it), TP_STEPS DDIM steps on the
    same noise, then the first step with the switched site forms on (K5,
    K6) and one decode of the fixed noise's first view with MVDF_CONV3X3=1
    (K8); without a mesh also the
    first step under the kernel-off switch. Returns host copies and each
    part's launches and seconds."""
    import torch

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.core.schedule import ddim_step, make_ddim_schedule
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusionConfig
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    cfg = ViewFusionConfig().tiny() if tiny else ViewFusionConfig()
    model = build_model(dev.type, cfg)
    if mesh is not None:
        parallel.shard_params_(model, mesh)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    scene = flagship_scene(model, dev)
    S, B, ls = 9, 8, cfg.latent_size
    IMG = ls * 2 ** (len(cfg.vae_ch_mult) - 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    draw = lambda *shape: torch.randn(shape, generator=g, device=dev)
    images = torch.rand(S, IMG, IMG, 3, generator=g, device=dev)
    init, steps, jitter = draw(B, ls, ls, 5), draw(TP_STEPS, B, ls, ls, 5), draw(TP_STEPS, B, ls, ls, cfg.n_pts_per_ray)
    ddim = make_ddim_schedule(cfg.timesteps, TP_STEPS, cfg.linear_start, cfg.linear_end, device=dev)
    t = ddim.timesteps[TP_STEPS - 1].expand(B)
    step = lambda: ddim_step(ddim, init, model.apply_model_cfg(init, cams, in_lat, in_cams, clip_v, t, 2.5, jitter[0]),
                             TP_STEPS - 1, steps[0])[0]  # the sampler's first step
    out, secs, counts = {}, {}, {}
    with torch.no_grad():
        _lib.reset_launches()
        sync()
        t0 = time.perf_counter()
        _, *prepared = model.prepare_batch(images, scene["R"], scene["T"], scene["f"], scene["c"],
                                           scene["input_idx"], scene["target_idx"])
        sync()
        secs["prepare"] = time.perf_counter() - t0
        cams, in_lat, in_cams, clip_v = prepared
        out["step"] = step()
        sync()
        t0 = time.perf_counter()
        out["latents"] = ddim_sample(model, *prepared, 2.5, num_steps=TP_STEPS, init_noise=init, step_noise=steps,
                                     jitter_noise=jitter).latents
        sync()
        secs["steps"] = time.perf_counter() - t0
        counts["default"] = dict(_lib.LAUNCHES)
        _lib.reset_launches()
        set_forms(True)
        set_vae_forms(False, True)
        try:
            out["forms_step"] = step()
            sync()
            t0 = time.perf_counter()
            out["decoded"] = model.decode_latents(init[:1, ..., :4])  # the same latent on both sides
            sync()
            secs["decode"] = time.perf_counter() - t0
        finally:
            set_forms(False)
            set_vae_forms(False, False)
        counts["switched"] = dict(_lib.LAUNCHES)
        out.update(input_latents=in_lat, clip_v=clip_v)
        if mesh is None:  # the noise scale: the same step with every kernel off
            with _lib.plain_versions():
                out["step_plain"] = step()
    return dict(out={k: v.float().cpu() for k, v in out.items()}, secs=secs, counts=counts,
                prints=[_checksum(v.float()) for v in out.values()])


def train_gap(run: dict, one: dict) -> dict:
    """A split train step (dp_step on a mesh) against one rank's (the same
    step alone): the loss; the gradient's max|diff| and max|g| over the
    model; by leaf, max|diff| / that leaf's max|g| and ||diff|| / ||g||
    (each leaf's max|g| taken as at least TP_LEAF_FLOOR x the model's),
    with the leaves that read most of each; and the masters' largest share
    of the gap their two gradients explain through AdamW's first step (the
    dp phase's rule, DP_*)."""
    import torch

    lr, eps = one["lr"], 1e-8
    g_err = g_top = m_ratio = 0.0
    worst, leaf_max, leaf_norm = {}, {}, {}
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    g_top = max(g.abs().max().item() for g in one["grads"].values())
    for k, g in run["grads"].items():
        g, rg, gm, rm = (t.to(dev) for t in (g, one["grads"][k], run["masters"][k], one["masters"][k]))
        d = (g - rg).abs().max().item()
        g_err = max(g_err, d)
        floor = TP_LEAF_FLOOR * g_top
        leaf_max[k] = d / max(rg.abs().max().item(), floor)
        leaf_norm[k] = (g - rg).double().norm().item() / max(rg.double().norm().item(), floor * rg.numel() ** 0.5)
        apart = gm != rm
        if apart.any():
            a, b, w = g[apart].double(), rg[apart].double(), rm[apart]
            explained = lr * (a / (a.abs() + eps) - b / (b.abs() + eps)).abs()
            up = lambda x: (torch.nextafter(x.abs(), torch.tensor(float("inf"), device=dev)) - x.abs()).double()
            ulp = 0.5 * (up(gm[apart]) + up(w))  # each side's subtraction rounds to half an ulp of its own result
            allow = explained + lr * TP_UPDATE_ULPS * 2.0**-24 + ulp
            ratio = (gm[apart] - w).double().abs() / allow
            i = int(ratio.argmax())
            if ratio[i].item() > m_ratio:
                m_ratio = ratio[i].item()
                worst = dict(name=k, ratio=m_ratio, master=gm[apart][i].item(), master_one=w[i].item(),
                             g=a[i].item(), g_one=b[i].item(), explained=explained[i].item(), ulp=ulp[i].item())
    most = lambda by: [(k, by[k]) for k in sorted(by, key=by.get, reverse=True)[:3]]
    return dict(loss=run["loss"], step_s=run["step_s"], reduces=run["reduces"], grad_err=g_err, grad_top=g_top,
                leaf_max=max(leaf_max.values()), leaf_norm=max(leaf_norm.values()), leaves_max=most(leaf_max),
                leaves_norm=most(leaf_norm), master_ratio=m_ratio, worst_master=worst,
                copies_are_masters=run["copies_are_masters"])


def train_gap_checks(part: str, r: dict, one: dict, card: str) -> list:
    """Log a train_gap and return its checks under the TP_* rules, as
    (ok, message) pairs for the caller to hold once every reading is in
    the log."""
    loss_gap = abs(r["loss"] - one["loss"]) / abs(one["loss"])
    log(f"  {part} train step: {r['step_s']:.3f} s (rank 0 alone {one['step_s']:.3f} s), loss {r['loss']:.6f} against "
        f"{one['loss']:.6f} (gap {loss_gap:.3e}, rule {TP_LOSS_RTOL:g}); gradient max|diff| {r['grad_err']:.3e}, "
        f"max|g| {r['grad_top']:.3e} ({r['grad_err'] / r['grad_top']:.3e} of it); by leaf, max|diff| / the leaf's "
        f"max|g| (at least {TP_LEAF_FLOOR:g} x max|g|) at most {r['leaf_max']:.3e} (rule {TP_LEAF_RTOL:g}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in r["leaves_max"]) + f"), ||diff|| / ||g|| at most {r['leaf_norm']:.3e} ("
        + ", ".join(f"{k} {v:.3e}" for k, v in r["leaves_norm"]) + f"); masters at most {r['master_ratio']:.3f} of "
        f"the gap the gradients explain ({r['worst_master']}); gather_params = the whole masters cast: "
        f"{r['copies_are_masters']}; "
        + "; ".join(f"all-reduce of {x['bytes']} bytes in {x['s']:.3f} s" for x in r["reduces"] if x["bytes"] > 8)
        + f"; on {card}")
    return [(loss_gap <= TP_LOSS_RTOL, f"{part}: the loss differs ({loss_gap:.3e})"),
            (r["grad_top"] > 0 and r["leaf_max"] <= TP_LEAF_RTOL,
             f"{part}: a leaf's gradient differs ({r['leaves_max'][0]})"),
            (r["master_ratio"] <= 1, f"{part}: the masters differ more than the gradients explain"),
            (r["copies_are_masters"], f"{part}: gather_params differs from the gathered masters")]


def par_rank(device: str, tiny: bool, parts: tuple, out: str) -> None:
    """One of DP_RANKS ranks of the dp and tp phases (parallel.spawn, gloo:
    they share the card), for `parts` of ("dp", "tp"). dp: the ranks take
    the train step on one scene each, the gradient averaged over them;
    then rank 0 alone, while the others wait, takes it on both scenes and
    holds the two against each other, then (tp) takes the step on scene 0
    and answers the request at tp = 1. tp: the ranks answer the request at
    tp = 2 (a), take one train step at sp = 2 (c), then at tp = 2 (b), each
    held by rank 0 against its own run alone as it comes. One train_model
    a process serves every step; host copies of a step's gradient and
    masters are taken by rank 0 alone, for the runs the others are held
    to. Rank 0 writes `out` (JSON): "dp" and "tp" as run_dp and run_tp read
    them, and the seconds of its parts."""
    import gc

    import torch
    import torch.distributed as dist

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.parallel import tensor

    dev = parallel.init_distributed(device)
    cuda = dev.type == "cuda"
    world = parallel.make_mesh(device=dev)
    tp_mesh = parallel.make_mesh(dp=1, tp=TP_RANKS, device=dev)
    sp_mesh = parallel.make_mesh(dp=1, sp=TP_RANKS, device=dev)
    main = world.rank == 0
    free = lambda: (gc.collect(), torch.cuda.empty_cache() if cuda else None)
    peak = lambda: torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    info = {p: dict(backend=dist.get_backend(), world=world.world) for p in parts}
    secs, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        secs[name], t0 = time.perf_counter() - t0, time.perf_counter()

    model = train_model(dev, tiny)
    lap("start: the process group and the train model's build")
    if "dp" in parts:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        per = DP_RANKS // world.world
        got = dp_step(dev, model, range(world.rank * per, (world.rank + 1) * per), reduce=True, keep=main)
        prints = parallel.gather_objects(got["prints"])
        info["dp"].update(reduces=got["reduces"], step_s=got["step_s"], loss=got["loss"], peak_gib=peak(),
                          ranks_agree=all(p == prints[0] for p in prints), trainable=got["trainable"],
                          numel=got["numel"], lr=got["lr"])
        lap("dp: the ranks' step")
    if main:  # alone, while the other ranks wait
        if "dp" in parts:
            ref = dp_step(dev, model, range(DP_RANKS), reduce=False, against=got, gap=lambda run, got: dp_gap(got, run))
            info["dp"].update(ref["gap"])
            del got, ref
            free()
            lap("dp: rank 0 alone on both scenes, and the comparison")
        if "tp" in parts:
            one = dp_step(dev, model, range(1), reduce=False, keep=True)
            lap("tp: rank 0 alone, the train step")
            a1 = tp_sample(dev, tiny)
            free()
            lap("tp: rank 0 alone, the request")
    parallel.barrier()
    lap("the ranks meet")
    if "tp" in parts:
        r = info["tp"]
        if cuda:  # gloo's all_gather on CUDA tensors, which tensor.all_gather takes (torch's table lists it for CPUs)
            probe = torch.full((4,), float(tp_mesh.rank), device=dev)
            try:
                got = tensor.all_gather(probe, tp_mesh.axes["tp"])
                r["gloo_cuda_all_gather"] = "ok" if [float(p[0]) for p in got] == [0.0, 1.0] else "wrong values"
            except Exception as e:
                r["gloo_cuda_all_gather"] = f"refused: {type(e).__name__}: {str(e)[:120]}"
            check(r["gloo_cuda_all_gather"] == "ok", f"gloo's all_gather on CUDA: {r['gloo_cuda_all_gather']}")
            torch.cuda.reset_peak_memory_stats()
        a = tp_sample(dev, tiny, tp_mesh)
        free()
        lap("tp: (a) the request at tp = 2")
        against = dict(against=one, gap=train_gap) if main else {}
        c = dp_step(dev, model, range(1), reduce=True, mesh=sp_mesh, **against)
        free()
        lap("tp: (c) the train step at sp = 2, and its comparison")
        b = dp_step(dev, model, range(1), reduce=True, mesh=tp_mesh, **against)
        r["peak_gib"] = peak()
        prints = parallel.gather_objects([a["prints"], b["prints"], c["prints"]])
        r["ranks_agree"] = [all(p[i] == prints[0][i] for p in prints) for i in range(3)]
        lap("tp: (b) the train step at tp = 2, and its comparison")
        if main:
            gap = lambda x, y: float((x - y).abs().max())
            top = lambda y: float(y.abs().max())
            r.update(tp=b["gap"], sp=c["gap"], secs=a["secs"], secs_one=a1["secs"], counts=a["counts"],
                     train_counts=b["counts"], sp_counts=c["counts"], one=dict(loss=one["loss"], step_s=one["step_s"]),
                     sample={k: dict(gap=gap(v, a1["out"][k]), mean=float((v - a1["out"][k]).abs().mean()),
                                     top=top(a1["out"][k]), finite=bool(torch.isfinite(v).all()))
                             for k, v in a["out"].items()},
                     plain=dict(gap=gap(a1["out"]["step"], a1["out"]["step_plain"]),
                                top=top(a1["out"]["step_plain"])))
    if main:
        with open(out, "w") as fp:
            json.dump(dict(info, secs=secs), fp)


def run_ranks(device: str = "cuda", tiny: bool = False, parts: tuple = ("dp", "tp")) -> dict:
    """DP_RANKS ranks of par_rank in one spawn (one process start and one
    train model build a rank for the dp and the tp phases); logs rank 0's
    parts and returns its results by part."""
    import gc
    import tempfile

    import torch

    from mvdfusion_tpu_torch import parallel

    if device == "cuda":  # the ranks share the card with this process: hand back its cached blocks
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card before the ranks start")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.spawn(par_rank, DP_RANKS, (device, tiny, tuple(parts), os.path.join(tmp, "ranks.json")))
        wall = time.perf_counter() - t0
        res = json.loads((Path(tmp) / "ranks.json").read_text())
    by = {p: sum(v for k, v in res["secs"].items() if k.startswith(p + ":")) for p in parts}
    log(f"  {DP_RANKS} ranks for {' and '.join(parts)}: {wall:.1f}s with the processes' start and the models' builds"
        + "".join(f"; {p}'s parts {v:.1f}s" for p, v in by.items()))
    log("  rank 0's parts: " + ", ".join(f"{k} {v:.3f}s" for k, v in res["secs"].items()))
    return res


def tp_cards_rank(out: str) -> None:
    """One of four ranks, one a card (init_distributed takes NCCL): rank 0
    first takes the step alone, then the ranks one train step at (dp=1,
    sp=2, tp=2) (dp_step on scene 0); rank 0 writes `out` (JSON)."""
    import torch.distributed as dist

    from mvdfusion_tpu_torch import parallel

    dev = parallel.init_distributed("cuda")
    mesh = parallel.make_mesh(dp=1, sp=2, tp=2, device=dev)
    model = train_model(dev, False)
    against = {}
    if mesh.rank == 0:
        one = dp_step(dev, model, range(1), reduce=False, keep=True)
        against = dict(against=one, gap=train_gap)
    parallel.barrier()
    run = dp_step(dev, model, range(1), reduce=True, mesh=mesh, **against)
    prints = parallel.gather_objects(run["prints"])
    if mesh.rank != 0:
        return
    info = dict(backend=dist.get_backend(), world=mesh.world, ranks_agree=all(p == prints[0] for p in prints),
                gap=run["gap"], one=dict(loss=one["loss"], step_s=one["step_s"]))
    with open(out, "w") as fp:
        json.dump(info, fp)


def run_tp_cards(card: str) -> dict:
    """--tp-cards: four ranks, one a card, over NCCL, one train step at (dp=1,
    sp=2, tp=2) against rank 0 alone, held to the tp phase's rules."""
    import tempfile

    import torch

    from mvdfusion_tpu_torch import parallel

    n = torch.cuda.device_count()
    check(n >= 4, f"--tp-cards needs four cards, this machine has {n}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.spawn(tp_cards_rank, 4, (os.path.join(tmp, "cards.json"),))
        log(f"  4 ranks and the comparison: {time.perf_counter() - t0:.1f}s")
        res = json.loads((Path(tmp) / "cards.json").read_text())
    log(f"  4 ranks, one a card ({res['backend']}), ranks bit-equal: {res['ranks_agree']}")
    check(res["backend"] == "nccl", f"four ranks on four cards took {res['backend']}, not NCCL")
    check(res["ranks_agree"], "the ranks' gradients or masters differ")
    for ok, msg in train_gap_checks("(dp=1, sp=2, tp=2) over NCCL", res["gap"], res["one"], card):
        check(ok, msg)
    return res


def query_count_checks() -> None:
    """K4 and K4b at a query count that is not V x H x W x D: the first half
    of the views' query points (an sp rank's share), held to the kernels
    rows' rule (1 bf16 ulp of max|plain|, mean 3e-4 x max|plain|)."""
    import torch

    from mvdfusion_tpu_torch.ops import crossview as K4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    rnd = lambda *shape, std=1.0, dt=torch.float32: (torch.randn(shape, generator=g, device=dev) * std).to(dt)
    for name, launch, plain, V in (("crossview", K4.launch_crossview, K4.crossview_plain, 8),
                                   ("crossview_two_phase", K4.launch_crossview_two_phase,
                                    K4.crossview_two_phase_plain, 15)):
        args, N, _, _ = cv_inputs(K4, rnd, dev, V, 32, 256, 3, 8, 768, torch.bfloat16)
        n = (V // 2) * 32 * 32
        args = (args[0][:, :n].contiguous(), args[1][:n].contiguous(), *args[2:4], args[4][:n].contiguous(), *args[5:])
        compare_ulp(f"{name} V={V} at N={n} queries (of {N})", launch(*args), plain(*args),
                    "an sp rank's share of the query points", mean_tol=3e-4)


def run_tp(card: str, device: str = "cuda", tiny: bool = False, res=None) -> dict:
    """The tp phase: on the card first K4 and K4b at an sp rank's query
    count; then TP_RANKS ranks over gloo on the card (`res`: run_ranks's
    "tp", else run_ranks for the tp part alone) held to rank 0's own runs
    alone (TP_* rules), the ranks to each other (bit-equal), and the
    launches of each part. `device`/`tiny` let it be rehearsed on the CPU
    (no launches there)."""
    if device == "cuda":
        query_count_checks()
    if res is None:
        res = run_ranks(device, tiny, ("tp",))["tp"]
    log(f"  {TP_RANKS} ranks ({res['backend']}); gloo's own all_gather on CUDA tensors: "
        f"{res.get('gloo_cuda_all_gather', 'not asked (CPU)')}; peak memory {res['peak_gib']:.2f} GiB a rank")
    check(res["backend"] == "gloo", f"{TP_RANKS} ranks on one device took {res['backend']}, not gloo")
    secs = lambda d: ", ".join(f"{k} {v:.3f}s" for k, v in d.items())
    log(f"  (a) tp = 2 request: {secs(res['secs'])}; rank 0 alone at tp = 1: {secs(res['secs_one'])}; on {card}")
    for k, r in res["sample"].items():
        log(f"  (a) {k}: max|tp2 - tp1| {r['gap']:.3e}, mean {r['mean']:.3e}, max|tp1| {r['top']:.3e}")
        check(r["finite"], f"tp: non-finite {k}")
    p = res["plain"]
    log(f"  (a) the noise scale: rank 0's first step at tp = 1, the kernels against the kernel-off switch: max|diff| "
        f"{p['gap']:.3e}, max|plain| {p['top']:.3e}")
    checks = []  # held once every reading is in the log
    for k, rtol in (("step", TP_STEP_RTOL), ("forms_step", TP_STEP_RTOL), ("decoded", TP_VAE_RTOL)):
        r = res["sample"][k]
        allow = rtol * max(1.0, r["top"])
        log(f"  (a) {k}: {r['gap']:.3e} against {rtol:g} x max(1, max|tp1|) = {allow:.3e} -> "
            f"{'ok' if r['gap'] <= allow else 'MISS'}")
        checks.append((r["gap"] <= allow, f"tp: {k} differs from tp = 1 ({r['gap']:.3e} > {allow:.3e})"))
    checks.append((all(res["ranks_agree"]),
                   f"tp: the ranks' outputs differ (request, tp step, sp step: {res['ranks_agree']})"))
    for part in ("tp", "sp"):
        checks += train_gap_checks(f"({'b' if part == 'tp' else 'c'}) {part} = 2", res[part], res["one"], card)
    for part, counts in (("(a) request", res["counts"]["default"]), ("(a) switched forms", res["counts"]["switched"]),
                         ("(b) tp train step", res["train_counts"]), ("(c) sp train step", res["sp_counts"])):
        log(f"  {part}, rank 0's launches: " + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    if device == "cuda":
        for names, part in ((TP_KERNELS, "default"), (TP_SWITCHED, "switched")):
            for k, row in names.items():
                checks.append((res["counts"][part].get(k, 0) > 0, f"tp: {row} ({k}) did not run on the split path"))
    for ok, msg in checks:
        check(ok, msg)
    return res


# ---------------------------------------------------------------- phase 14
# the learning proof at tests/test_learning.py's sizes: the tiny model in fp32,
# 2 scenes of the mixed family with textures, 120 VAE steps, 260 diffusion
# steps, 8-step DDIM on views 3 and 11
LEARN_ARGS = dict(scenes=2, vae_steps=120, steps=260, eval_ddim_steps=8, lr=1e-3, vae_lr=3e-3, seed=SEED,
                  log_every=50, family="mixed", textured=True)
LEARN_VIEWS = [3, 11]
# the trained evaluation with the kernels against the same scene under
# MVDF_DISABLE_PALLAS=1 on the same noise: fp32 on both sides, the kernels
# sum in other orders, and 8 eta=1 steps carry the differences on
LEARN_PLAIN_RTOL = 1e-3  # max|diff| <= this x max(1, max|plain|), decoded views and sampled depth


def run_learn(card: str, device: str = "cuda") -> dict:
    """tests/test_learning.py's proof through the port's
    tools/overfit_synthetic.py (init_params, pretrain_vae, evaluate,
    train_diffusion): checks its four thresholds (VAE PSNR > 14 dB; the mean
    of the last 40 losses < 0.62 x the first 40's; trained PSNR > floor +
    1.5 dB; depth MAE below the floor's), that the VAE pretrain launched K1
    and the trained evaluation K1, K3 and K4 (on the card), and holds one
    scene's trained evaluation against the same under the kernel-off switch
    on the same noise (LEARN_PLAIN_RTOL)."""
    import tempfile

    import numpy as np
    import torch

    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.tools import overfit_synthetic as O

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpd:
        args = O.OverfitArgs(**LEARN_ARGS, out=tmpd, device=device)
        _, batch = O.build_dataset(args)
        model, _ = O.build_model(args)
        O.init_params(model, args.seed)
        _lib.reset_launches()
        t0 = time.perf_counter()
        vae_psnr, _ = O.pretrain_vae(model, batch, args)
        sync()
        vae_s, vae_counts = time.perf_counter() - t0, dict(_lib.LAUNCHES)
        t0 = time.perf_counter()
        _, floor = O.evaluate(model, batch, args, eval_views=LEARN_VIEWS, tag="floor")
        floor_s = time.perf_counter() - t0
        _, losses, train_s = O.train_diffusion(model, batch, args)
        _lib.reset_launches()
        t0 = time.perf_counter()
        _, trained = O.evaluate(model, batch, args, eval_views=LEARN_VIEWS, tag="trained")
        eval_s, counts = time.perf_counter() - t0, dict(_lib.LAUNCHES)
        with _lib.plain_versions():
            _, plain = O.evaluate(model, batch, args, eval_views=LEARN_VIEWS, tag="plain", scenes=[0])
            plain_launches = sum(_lib.LAUNCHES.values()) - sum(counts.values())
    mean_psnr = lambda res: float(np.mean([p for r in res for p in r["psnr"]]))
    floor_psnr, trained_psnr = mean_psnr(floor), mean_psnr(trained)
    floor_dmae = float(np.mean([r["depth_mae"] for r in floor]))
    trained_dmae = float(np.mean([r["depth_mae"] for r in trained]))
    first, last = float(np.mean(losses[:40])), float(np.mean(losses[-40:]))
    log(f"  VAE: {args.vae_steps} steps in {vae_s:.2f}s, recon PSNR {vae_psnr:.2f} dB (threshold 14); launches "
        f"{vae_counts}")
    log(f"  diffusion: {args.steps} steps of {args.scenes} scenes in {train_s:.2f}s ({train_s / args.steps:.4f} s a "
        f"step), loss first 40 {first:.4f} -> last 40 {last:.4f} (threshold x0.62 = {0.62 * first:.4f})")
    log(f"  eval ({args.eval_ddim_steps} DDIM steps, views {LEARN_VIEWS}, {args.scenes} scenes): floor "
        f"{floor_s:.2f}s, trained {eval_s:.2f}s; PSNR floor {floor_psnr:.2f} -> trained {trained_psnr:.2f} dB "
        f"(threshold floor + 1.5 = {floor_psnr + 1.5:.2f}); depth MAE floor {floor_dmae:.4f} -> trained "
        f"{trained_dmae:.4f}; launches in the trained evaluation {counts}")
    check(vae_psnr > 14.0, f"the VAE did not learn: {vae_psnr:.2f} dB")
    check(last < 0.62 * first, f"no loss progress: {first:.4f} -> {last:.4f}")
    check(trained_psnr > floor_psnr + 1.5, f"novel-view PSNR did not improve: {floor_psnr:.2f} -> {trained_psnr:.2f}")
    check(trained_dmae < floor_dmae, f"depth MAE did not improve: {floor_dmae:.4f} -> {trained_dmae:.4f}")
    for key, what in (("rgb", "decoded views"), ("depth_pred", "sampled depth")):
        got, want = (torch.as_tensor(r[0][key]) for r in (trained, plain))
        compare(f"learn: scene 0's trained {what} (views {LEARN_VIEWS})", got, want, LEARN_PLAIN_RTOL,
                "fp32 kernels against the kernel-off switch on the same noise, through 8 eta=1 DDIM steps and the "
                "VAE decode", torch.float32)
    check(plain_launches == 0, f"{plain_launches} launches under the kernel-off switch")
    if dev.type == "cuda":
        check(vae_counts.get("groupnorm", 0) > 0, "the VAE pretrain launched no K1")
        for key, name in (("groupnorm", "K1"), ("transformer_block", "K3"), ("crossview", "K4")):
            check(counts.get(key, 0) > 0, f"the trained evaluation launched no {name} ({key})")
    log(f"  learn phase {time.perf_counter() - t_phase:.2f}s on {card}")
    return dict(vae_psnr=vae_psnr, floor_psnr=floor_psnr, trained_psnr=trained_psnr, floor_dmae=floor_dmae,
                trained_dmae=trained_dmae, loss_first=first, loss_last=last, counts=counts, vae_counts=vae_counts)


def gn_timers() -> None:
    """K7's passes and K8's statistics pass at the VAE's large maps in bf16,
    by device_ms: the stats pass, the apply pass, both, and gn_fold_affine,
    each against its bound. It calls only entry points that older trees of
    the port have too (launch_fold, launch_apply_affine,
    launch_group_norm_tiled, launch_gn_fold_affine), so copy it into an
    unpacked parent tree to compare two trees alike."""
    import torch

    from mvdfusion_tpu_torch.ops import conv3x3 as K8
    from mvdfusion_tpu_torch.ops import groupnorm as K1

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    for B, N, C in ((8, 65536, 128), (8, 65536, 256), (9, 16384, 256), (8, 4096, 512), (7, 16384, 512)):
        x = (torch.randn(B, N, C, generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
        b = 0.1 * torch.randn(C, generator=g, device=dev)
        gn_pass_times(K1, x, w, b, *K1.launch_fold(x, w, b, 32, 1e-6, True))
        fold = device_ms(lambda: K8.launch_gn_fold_affine(x, w, b, 32, 1e-6), ITERS)
        bms = nbytes(x) / PEAK_BYTES * 1e3
        log(f"  gn_fold_affine {(B, N, C)}: {fold:.4f} ms, bound {bms:.4f} ({bms / fold:.1%})")


def _host_syncs(events) -> tuple:
    """(host-to-device copies, stream or device synchronisations) among a
    trace's events: the copies' device records and the runtime calls' host
    records."""
    h2d = sum(e.count for e in events if str(e.device_type).endswith("CUDA") and "HtoD" in e.key)
    syncs = sum(e.count for e in events if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    return h2d, syncs


def profile_steps(model, prepared, steps: int, top: int = 18, what: str = "flagship",
                  feed_prev_depth: bool = False) -> None:
    """torch.profiler over `steps` sampling steps: device time by kernel name
    per step, the device's busy share of the wall time, and the host-to-device
    copies and synchronisations a step makes (each one stalls the host, and
    none can be captured in a CUDA graph)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            ddim_sample(model, *prepared, 2.5, num_steps=steps, generator=g, feed_prev_depth=feed_prev_depth)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summarize_profile(prof, wall, steps, what, "step", top)


def summarize_profile(prof, wall: float, steps: int, what: str, unit: str, top: int = 18) -> None:
    """Log a torch.profiler session of `steps` units: device busy share of
    `wall`, kernel launches, copy kernels, host-to-device copies and
    synchronisations a unit, then the `top` kernels by device time."""
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    averages = prof.key_averages()
    # kernel events only (device_type CUDA): an aten op's self device time
    # repeats the time of the kernels it launched
    events = [e for e in averages if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    if not events:
        log(f"  profile ({what}): the trace holds no device events (device time not measured)")
        return
    busy = sum(dev_us(e) for e in events) / 1e6
    launches = sum(e.count for e in events)
    copies = [e for e in events if "copy" in e.key.lower()]
    h2d, syncs = _host_syncs(averages)
    u = unit
    log(f"  profile ({what}) of {steps} {u}s: wall {wall / steps * 1e3:.2f} ms/{u} (profiled), device busy "
        f"{busy / steps * 1e3:.2f} ms/{u} = {100 * busy / wall:.1f}% of wall; {launches / steps:.1f} kernel "
        f"launches/{u}; copy kernels {sum(dev_us(e) for e in copies) / steps / 1e3:.3f} ms/{u} in "
        f"{sum(e.count for e in copies) / steps:.1f} launches/{u}; host-to-device copies {h2d / steps:.1f}/{u}, "
        f"synchronisations {syncs / steps:.1f}/{u} (the trace's whole window)")
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"    {dev_us(e) / steps / 1e3:9.3f} ms/{u} {e.count / steps:7.1f} calls/{u}  {e.key[:110]}")


# K4's kernels by stage, from their names (csrc/crossview.cu, block.cu,
# gemm_sm90.cu); the GEMMs are told apart by the stage before them
_STAGE_OF = (("cv_gather", "gather"), ("cv_token_gelu", "GELU pass"), ("qkv_attention", "qkv + attention"),
             ("cv_attention", "attention"), ("cv_pool", "pool"), ("layernorm", "LN"), ("gemm", "GEMM"),
             ("HtoD", "host-to-device copy"))


def crossview_stages(fn, iters: int = 10) -> dict:
    """Device ms per call of one K4 form (`fn`) by stage, from a trace of
    `iters` calls: the gather, K4b's GELU pass where it exists, LN1 and LN2,
    the qkv GEMM and the attention (or the two in one kernel), proj, fc1,
    fc2, the pool and the final GEMM; "other" sums PyTorch's own kernels.
    Also the kernels, host-to-device copies and synchronisations a call
    makes. Reads only kernel names, so it times any tree of the port alike."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = sorted(prof.events(), key=lambda e: e.time_range.start)
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    ms, ln, after = collections.Counter(), 0, None
    for e in kernels:
        stage = next((s for key, s in _STAGE_OF if key in e.name), "other")
        if stage == "LN":
            ln += 1
            stage = after = "LN1" if ln % 2 else "LN2"
        elif stage == "GEMM":
            stage = {"LN1": "qkv", "attention": "proj", "qkv + attention": "proj", "LN2": "fc1", "fc1": "fc2",
                     "pool": "final"}.get(after, "GEMM")
            after = stage
        elif stage in ("attention", "qkv + attention", "pool"):
            after = stage
        ms[stage] += (e.time_range.end - e.time_range.start) / 1e3 / iters
    h2d, syncs = _host_syncs(prof.key_averages())
    return dict(stages=dict(ms), total=sum(ms.values()), kernels=len(kernels) / iters, h2d=h2d / iters,
                syncs=syncs / iters)


def crossview_stage_checks(rows) -> None:
    """K4's and K4b's rows by stage (crossview_stages on the call each row
    keeps), their kernels a call held to K4_CALL_LAUNCHES with no copy from
    the host. Run after the timed phases: a profiler session leaves the
    process's later launches slower on the host."""
    for name in ("crossview", "crossview_two_phase"):
        r = rows[name]
        st = crossview_stages(r.pop("stages_call"))
        log_stages(f"{name} ({r['shape']})", st)
        check(st["kernels"] <= K4_CALL_LAUNCHES, f"{name}: {st['kernels']:g} kernels a call, the path implies "
                                                 f"{K4_CALL_LAUNCHES}")
        check(st["h2d"] == 0, f"{name}: {st['h2d']:g} host-to-device copies a call")
        r.update(stages_ms=st["stages"], kernels_a_call=st["kernels"])


def log_stages(name: str, st: dict) -> None:
    log(f"  {name} by stage (device ms a call, traced): " + ", ".join(f"{k} {v:.4f}" for k, v in st["stages"].items())
        + f"; sum {st['total']:.4f}; {st['kernels']:g} kernels, {st['h2d']:g} host-to-device copies and "
        f"{st['syncs']:g} synchronisations a call")


def crossview_readings() -> None:
    """K4 (V=8) and K4b (V=15) at chip_smoke's shapes in bf16, on prepared
    weights: the stage breakdown and each form's gap to its plain version in
    bf16 ulps of max|plain| and its mean (logged, not held: the same reading
    serves a parent tree)."""
    import torch

    from mvdfusion_tpu_torch.ops import crossview as K4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s, std=1.0, dt=torch.float32: (torch.randn(s, generator=g, device=dev) * std).to(dt)
    for name, V, launch, plain in (("crossview", 8, K4.launch_crossview, K4.crossview_plain),
                                   ("crossview_two_phase", 15, K4.launch_crossview_two_phase,
                                    K4.crossview_two_phase_plain)):
        args, *_ = cv_inputs(K4, rnd, dev, V, 32, 256, DIT_LAYERS, 8, 768, torch.bfloat16)
        try:
            kw = K4.prepare_crossview_weights(args[6], args[7], torch.bfloat16, 8, args[9])
        except TypeError:  # an older tree of the port: no per-head packing, no frequency tensor
            kw = K4.prepare_crossview_weights(args[6], args[7], torch.bfloat16)
        got, want = launch(*args[:6], *kw, *args[8:]).float(), plain(*args).float()
        diff = (got - want).abs()
        top = want.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        log(f"  {name} V={V}: max|kernel - plain| = {diff.max().item() / ulp:.3f} bf16 ulp of max|plain| "
            f"{top:.3e}, mean {diff.mean().item() / top:.3e} x max|plain|")
        log_stages(f"{name} V={V}", crossview_stages(lambda: launch(*args[:6], *kw, *args[8:])))


def cv_inputs(K4, rnd, dev, V, Hh, hid, L, heads, out_dim, dt):
    """K4's operands at V views of Hh^2 points, random from `rnd`: (args,
    N, mlp, G) with args as launch_crossview takes them."""
    import torch

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


def eval_prepared(model, dev):
    """The evaluation scene's sampler inputs (run_eval's rig and images),
    for profiling its batch-30 step."""
    import numpy as np
    import torch

    from mvdfusion_tpu_torch.data.rigs import AZIMUTHS_16, ELEVATIONS_16, fixed_rig

    ls, B = model.cfg.latent_size, EVAL_TARGETS
    IMG = ls * 2 ** (len(model.cfg.vae_ch_mult) - 1)
    R, T, f, c = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)
    images = np.random.default_rng(SEED).uniform(size=(16, IMG, IMG, 3)).astype(np.float32)
    sel = np.linspace(0, 15, 1 + B).astype(np.int64)
    on = lambda a: torch.as_tensor(a, device=dev)
    with torch.no_grad():
        _, *prepared = model.prepare_batch(on(images), on(R), on(T), on(f), on(c), on(sel[:1]), on(sel[1:]))
    return prepared


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10, help="DDIM steps per request (50 is the flagship)")
    ap.add_argument("--eval-steps", type=int, default=10,
                    help="DDIM steps of the evaluation scene (50 is the paper's protocol)")
    ap.add_argument("--forms-steps", type=int, default=5,
                    help="DDIM steps of the request with the switched transformer-site forms on")
    ap.add_argument("--train-steps", type=int, default=1,
                    help="optimizer steps of the train phase (grad_accum_step calls each)")
    ap.add_argument("--learn", action="store_true",
                    help="after the train phase, the learning proof at tests/test_learning.py's sizes (run_learn, "
                         "~110 s)")
    ap.add_argument("--loader", action="store_true",
                    help="run the loader phase even where the host lacks the libjpeg, libpng or zlib headers")
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="after the checks, trace STEPS sampling steps with torch.profiler, on the default "
                         "route (slice), on the evaluation scene (eval) and with the switched forms on (forms), "
                         "and STEPS train calls (train)")
    ap.add_argument("--profile-only", type=int, default=0, metavar="STEPS",
                    help="only build the kernels, read K4 and K4b by stage and against their plain versions, "
                         "and trace STEPS flagship and STEPS evaluation steps on the default route, then STEPS "
                         "flagship steps with the switched site forms on")
    ap.add_argument("--k1-sweep", action="store_true",
                    help="only build the kernels and time K1 at every step shape on each cluster size")
    ap.add_argument("--k5-sweep", action="store_true",
                    help="only build the kernels and time K5 by phase, and K6's attention with one and two "
                         "warpgroups a block")
    ap.add_argument("--gn-timers", action="store_true",
                    help="only build the kernels and time K7's passes and K8's statistics pass at the VAE's "
                         "large maps (device_ms)")
    ap.add_argument("--tp-cards", action="store_true",
                    help="only build the kernels, then one train step at (dp=1, sp=2, tp=2) on four cards over NCCL, "
                         "one rank a card, against one rank alone (needs a four-card machine)")
    ap.add_argument("--site-timers", action="store_true",
                    help="only build the kernels and read the K3, K5 and K6 sites and K6's attention with both "
                         "timers (device_ms, time_ms)")
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
        missing_headers = loader_probe()

    from mvdfusion_tpu_torch.ops import _lib

    set_forms(False)  # the slice and eval phases take the default route
    set_vae_forms(False, False)
    with Phase("build"):
        shutil.rmtree(_lib.BUILD_DIR, ignore_errors=True)
        info = _lib.build(force=True)
        _lib.lib()
        log(f"  {len(_lib._sources())} nvcc compiles in parallel and one link, {info['seconds']:.2f}s -> {info['path']}")
        log("  each nvcc ended at: " + ", ".join(f"{k} {v:.1f}s" for k, v in sorted(info.get("sources", {}).items(),
                                                                                   key=lambda kv: kv[1])))
        for line in info["log"].splitlines():
            if "Compiling entry function" in line or "Used" in line or "spill" in line:
                log("  ptxas " + line.split("ptxas info    :")[-1].strip())

    if args.k1_sweep:
        with Phase("k1 sweep"):
            k1_sweep()
        return 0

    if args.k5_sweep:
        with Phase("k5 sweep"):
            k5_sweep()
        return 0

    if args.gn_timers:
        with Phase("gn timers"):
            gn_timers()
        return 0

    if args.site_timers:
        with Phase("site timers"):
            site_timers()
        return 0

    if args.tp_cards:
        with Phase("tp cards"):
            run_tp_cards(card)
        return 0

    if args.profile_only:
        with Phase("profile"):
            crossview_readings()
            model = build_model()
            dev = torch.device("cuda")
            _, prepared, _ = answer(model, flagship_scene(model, dev), 1, SEED + 1, dev)
            profile_steps(model, prepared, args.profile_only)
            profile_steps(model, eval_prepared(model, dev), args.profile_only, what="eval, CFG batch 30",
                          feed_prev_depth=model.cfg.feed_prev_depth)
            set_forms(True)
            try:
                answer(model, flagship_scene(model, dev), 1, SEED + 1, dev)  # the forms' workspaces and weights
                profile_steps(model, prepared, args.profile_only, what="forms")
            finally:
                set_forms(False)
        return 0

    with Phase("kernels"):
        rows = kernel_checks()

    with Phase("slice"):
        model = build_model()
        counts = run_slice(args.steps, card, profile=args.profile, model=model)

    with Phase("eval"):
        eval_counts = run_eval(args.eval_steps, card, model=model, profile=args.profile)
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

    with Phase("weights"):
        run_weights(card, model=model)

    with Phase("scenes"):
        scenes_counts = run_scenes(args.eval_steps, card, model=model, profile=args.profile)["counts"]

    if missing_headers and not args.loader:
        log(f"phase loader: skipped, the host lacks /usr/include/{', '.join(missing_headers)} (--loader runs it)")
    else:
        with Phase("loader"):
            run_loader(card)

    del model
    torch.cuda.empty_cache()
    with Phase("train"):
        run_train(card, args.train_steps, profile=args.profile)

    with Phase("dp"):  # the ranks run the dp phase's step and the tp phase's parts in one spawn
        ranks = run_ranks()
        run_dp(card, res=ranks["dp"])

    with Phase("tp"):
        run_tp(card, res=ranks["tp"])

    if args.learn:
        with Phase("learn"):
            run_learn(card)

    with Phase("stages"):
        crossview_stage_checks(rows)
        k1_launches_a_call()

    # launches of the phase that drives each kernel's path: the flagship
    # slice for K1-K4, the evaluation scene for the two-phase K4, the forms
    # request for K5 and K6, the VAE phase for K7 and K8; K1's, the
    # LayerNorm's and the GEMM's by shape in the phase its row names
    phase_of = {"crossview_two_phase": eval_counts, "transformer_block_single": forms_counts,
                "transformer_block_big": forms_counts, "big_attention": forms_counts, "groupnorm_tiled": vae_counts, "gn_fold_affine": vae_counts,
                "conv3x3": vae_counts}
    by_phase = {"slice": counts, "eval": eval_counts, "forms": forms_counts, "scenes": scenes_counts}
    for name, r in rows.items():
        if "launch_key" in r:
            r["launches"] = by_phase[r.pop("phase")].get(r.pop("launch_key"), 0)
            check(r["launches"] > 0, f"{name}: no launch at this shape on its path")
        else:
            r["launches"] = phase_of.get(name, counts).get(name, 0)
        r.pop("shape")
    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
