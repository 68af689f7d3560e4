"""The train step: masked AdamW over the reference's trainable-parameter set,
scene-batched (torch counterpart of mvdfusion_tpu/pipeline/trainer.py).

The reference's optimizer groups (cc_projection, the trainable UNet subset,
time_embed, view_attn) share one lr, so one masked AdamW is exactly
equivalent. VAE and CLIP are always frozen. On top of the reference: the
gradient accumulation its config declares (the mean over grad_accum_step
calls, optax.MultiSteps' semantics), and the rails the JAX package adds,
all off by default: global-norm clipping over the trainable set, the skip
on non-finite gradients (optax.apply_if_finite), a cosine lr schedule and
a parameter EMA. One departure: a skipped update clears the accumulator,
where optax.MultiSteps multiplies it by 0 and so keeps a NaN it holds.

Masters and compute copies. The model's layers compute in their weight's
dtype (bf16 towers, fp32 norms and small MLPs: ViewFusion.compute_dtypes).
The JAX package trains fp32 masters cast at use. Here the TrainState holds
the masters: fp32 for every trainable leaf; a frozen leaf in its compute
dtype or, under frozen_master_dtype "bfloat16", its matrices in bf16. The
model's parameters are the compute copies, refreshed from the masters after
each update (in place, so the kernels' prepared weights see the change);
where a master's dtype is its compute dtype, the master is the model's
parameter itself. The gradient of a compute copy is the gradient of its
master through the cast, as in JAX. Only the trainable set needs gradients.

Data parallelism. Under a process group (parallel/mesh.py) each rank runs
its own scenes, and the accumulator (the mean gradient over grad_accum_step
calls, a tensor for every trainable parameter on every rank) is averaged
over the ranks once per optimizer step, just before the update: the mean is
linear, so this equals averaging every call's gradient, at 1/grad_accum_step
of the traffic (DDP's no_sync). The skip test, the clip, AdamW and the EMA
then read the same gradient on every rank, which so hold the same masters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mvdfusion_tpu_torch import parallel

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_MAX_CONSECUTIVE_NONFINITE = 100  # optax.apply_if_finite's max_consecutive_errors here


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """trainer section of the YAML, field for field as the JAX package's."""

    lr: float = 1e-4
    grad_accum_step: int = 1
    finetune_projection: bool = True
    finetune_unet: bool = False
    finetune_cross_attn: bool = True
    finetune_view_attn: bool = True
    weight_decay: float = 0.01  # torch AdamW default
    grad_clip: float = 0.0  # global-norm clip over the trainable set; 0 = off
    skip_nonfinite: bool = False  # no update from non-finite gradients
    lr_schedule: str = "constant"  # constant | cosine over optimizer steps
    lr_decay_steps: int = 0
    lr_alpha: float = 0.1
    ema_decay: float = 0.0  # > 0: an EMA of the masters, warmup min(d, (1+t)/(10+t))
    frozen_master_dtype: str = "auto"  # auto | float32 | bfloat16
    # the kernels inside the train step: "never" takes the UNet sites' and
    # GridAttn's module paths (GroupNorm32 and the large-token attention keep
    # their kernels, as in the reference), "model" the model's own fuse_mode
    train_fuse_mode: str = "never"  # never | model


@dataclasses.dataclass
class TrainState:
    """params: name -> master tensor (the model's parameter itself where
    dtypes agree); opt_state: AdamW's moments and count, the accumulator and
    the skip counters (see _init_opt); step: calls so far; ema: name ->
    EMA tensor, or None."""

    params: dict
    opt_state: dict
    step: int = 0
    ema: Optional[dict] = None


def _site_kinds(model) -> dict:
    """'unet_model.unet_model.<block path>' -> "spatial" or "grafted" for
    every SpatialTransformer and ViewAlignedFeatureTransformer."""
    from mvdfusion_tpu_torch.nn.unet import SpatialTransformer, ViewAlignedFeatureTransformer

    kinds = {}
    for name, m in model.unet_model.named_modules():
        if isinstance(m, SpatialTransformer):
            kinds["unet_model." + name + "."] = "spatial"
        elif isinstance(m, ViewAlignedFeatureTransformer):
            kinds["unet_model." + name + "."] = "grafted"
    return kinds


def trainable_mask(model, tc: TrainConfig) -> dict:
    """state-dict name -> whether the reference optimizes it: GridAttn under
    finetune_view_attn, the aux time-embed MLP always, cc_projection under
    finetune_projection, the UNet all under finetune_unet, else its
    SpatialTransformer sites under finetune_cross_attn and its grafted
    view-aligned sites under finetune_view_attn; VAE and CLIP never."""
    kinds = _site_kinds(model)

    def decide(name: str) -> bool:
        top = name.split(".")[0]
        if top in ("vae", "clip_image_encoder"):
            return False
        if top == "view_attn":
            return tc.finetune_view_attn
        if top == "time_embed":
            return True
        if top == "cc_projection":
            return tc.finetune_projection
        if top == "unet_model":
            if tc.finetune_unet:
                return True
            kind = next((k for p, k in kinds.items() if name.startswith(p)), None)
            if kind == "grafted":
                return tc.finetune_view_attn
            return kind == "spatial" and tc.finetune_cross_attn
        return False

    return {n: decide(n) for n, _ in model.named_parameters()}


def learning_rate(tc: TrainConfig, count: int) -> float:
    """The lr of optimizer update `count` (0-based): constant, or
    optax.cosine_decay_schedule(lr, lr_decay_steps, lr_alpha)."""
    if tc.lr_schedule == "cosine":
        if tc.lr_decay_steps <= 0:
            raise ValueError("lr_schedule=cosine requires lr_decay_steps > 0")
        frac = min(count, tc.lr_decay_steps) / tc.lr_decay_steps
        return tc.lr * ((1 - tc.lr_alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + tc.lr_alpha)
    if tc.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")
    return tc.lr


def _master_dtype(tc: TrainConfig, model, trainable: bool, p) -> torch.dtype:
    if trainable:
        return torch.float32
    want = tc.frozen_master_dtype
    if want == "auto":
        want = "bfloat16" if model.cfg.dtype == torch.bfloat16 else "float32"
    if want == "bfloat16" and p.ndim >= 2 and p.dtype == torch.float32:
        return torch.bfloat16
    return p.dtype


def _init_opt(params: dict, mask: dict) -> dict:
    """AdamW's fp32 moments over the trainable set, its update count, the
    accumulator of the mean gradient over grad_accum_step calls and its
    position, and apply_if_finite's counters."""
    zeros = lambda: {n: torch.zeros_like(params[n], dtype=torch.float32) for n in params if mask[n]}
    return dict(count=0, mu=zeros(), nu=zeros(), acc=zeros(), mini_step=0, notfinite_count=0, total_notfinite=0)


def init_train_state(model, tc: TrainConfig) -> TrainState:
    """Masters from the model's parameters as they are (build the model in
    fp32), then the parameters cast to their compute dtypes (the compute
    copies), the trainable set requiring gradients and the rest not."""
    mask = trainable_mask(model, tc)
    dts = model.compute_dtypes()
    params = {}
    with torch.no_grad():
        for n, p in model.named_parameters():
            mdt = _master_dtype(tc, model, mask[n], p)
            if mdt == dts[n]:
                p.data = p.data.to(mdt)
                params[n] = p
            else:
                params[n] = p.detach().to(mdt, copy=True)
                p.data = params[n].to(dts[n])
            p.requires_grad_(mask[n])
    ema = {n: t.detach().clone() for n, t in params.items()} if tc.ema_decay > 0 else None
    return TrainState(params=params, opt_state=_init_opt(params, mask), step=0, ema=ema)


def eval_params(state: TrainState) -> dict:
    """The parameters eval should sample with: the EMA when tracked."""
    return state.params if state.ema is None else state.ema


def load_params(model, params: dict) -> None:
    """Copy `params` (name -> tensor, any dtype) into the model's compute
    copies, in place (their versions move, so prepared weights rebuild)."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            if params[n] is not p:
                p.copy_(params[n])


def scene_batch_loss(model, batch: dict, generator=None, draws=None):
    """The mean of p_losses over the scene axis of `batch` (images (N, S, H,
    W, 3), R (N, S, 3, 3), T (N, S, 3), f/c (N, S, 2), input_idx (N, 1),
    target_idx (N, B), optional depths) and its gradient: a loop over
    scenes, each scene's loss differentiated alone (one scene's activations
    live at once) and its gradient added into an fp32 sum as it comes, so a
    bf16 compute copy's gradient is rounded to bf16 once a scene and never
    summed in bf16. `draws`, a list of N dicts of p_losses' draws, replaces
    `generator`'s. Returns the mean loss (0-d) and name -> the fp32 mean
    gradient of each parameter that requires one (None where the loss does
    not reach it); leaves every .grad None."""
    n = batch["images"].shape[0]
    depths = batch.get("depths")
    wrt = [(name, p) for name, p in model.named_parameters() if p.requires_grad]
    for _, p in wrt:
        p.grad = None
    grads = dict.fromkeys(name for name, _ in wrt)
    total = 0.0
    for i in range(n):
        scene = (batch[k][i] for k in ("images", "R", "T", "f", "c", "input_idx", "target_idx"))
        loss = model.p_losses(*scene, depths=None if depths is None else depths[i], generator=generator,
                              **(draws[i] if draws else {}))
        loss.backward()
        total = total + loss.detach()
        with torch.no_grad():
            sums, adds = [], []
            for name, p in wrt:
                if p.grad is not None:
                    if grads[name] is None:
                        grads[name] = p.grad.float()
                    else:
                        sums.append(grads[name])
                        adds.append(p.grad)
                    p.grad = None
            if sums:
                torch._foreach_add_(sums, adds)
    with torch.no_grad():
        present = [g for g in grads.values() if g is not None]
        if present:
            torch._foreach_div_(present, n)
    return total / n, grads


def _optimizer_update(model, state: TrainState, tc: TrainConfig, grads: dict) -> bool:
    """One masked AdamW update of the trainable masters from `grads` (name ->
    fp32 mean gradient), after the skip test and the clip; refreshes the
    compute copies. Returns whether it applied."""
    opt = state.opt_state
    names = list(grads)
    gs = [grads[n] for n in names]
    if tc.skip_nonfinite:
        # one flag for the whole set (the check GradScaler runs; the scale 1 leaves gs as they are)
        found = torch.zeros(1, device=gs[0].device)
        torch._amp_foreach_non_finite_check_and_unscale_(gs, found, torch.ones((), device=gs[0].device))
        finite = not bool(found.item())
        opt["notfinite_count"] = 0 if finite else opt["notfinite_count"] + 1
        opt["total_notfinite"] += 0 if finite else 1
        if not finite and opt["notfinite_count"] <= _MAX_CONSECUTIVE_NONFINITE:
            return False
    if tc.grad_clip:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        if not bool(norm < tc.grad_clip):
            gs = torch._foreach_div(gs, norm)
            torch._foreach_mul_(gs, tc.grad_clip)
    lr = learning_rate(tc, opt["count"])
    opt["count"] += 1
    c1, c2 = 1 - _B1 ** opt["count"], 1 - _B2 ** opt["count"]
    params = {n: p for n, p in model.named_parameters()}
    mus, nus, masters = ([d[n] for n in names] for d in (opt["mu"], opt["nu"], state.params))
    with torch.no_grad():
        # per element: mu = B1 mu + (1 - B1) g; nu = B2 nu + (1 - B2) g^2;
        # master -= lr ((mu / c1) / (sqrt(nu / c2) + eps) + wd master)
        torch._foreach_mul_(mus, _B1)
        torch._foreach_add_(mus, gs, alpha=1 - _B1)
        torch._foreach_mul_(nus, _B2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - _B2)
        u = torch._foreach_div(mus, c1)
        den = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _EPS)
        torch._foreach_div_(u, den)
        torch._foreach_add_(u, torch._foreach_mul(masters, tc.weight_decay))
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(masters, u)
        copies = [(params[n], m) for n, m in zip(names, masters) if m is not params[n]]
        if copies:
            torch._foreach_copy_([c for c, _ in copies], [m for _, m in copies])
    return True


@torch.no_grad()
def _accumulate(opt: dict, grads: dict) -> None:
    """The running mean over an optimizer step's calls: acc += (g - acc) / (i
    + 1), a missing gradient counting as 0."""
    div = opt["mini_step"] + 1
    got = [(acc, grads[n]) for n, acc in opt["acc"].items() if grads.get(n) is not None]
    none = [acc for n, acc in opt["acc"].items() if grads.get(n) is None]
    if got:
        step = torch._foreach_sub([g for _, g in got], [a for a, _ in got])
        torch._foreach_div_(step, div)
        torch._foreach_add_([a for a, _ in got], step)
    if none:
        torch._foreach_sub_(none, torch._foreach_div(none, div))


def train_step(model, state: TrainState, batch: dict, tc: TrainConfig, generator=None, draws=None):
    """One call: scene_batch_loss's loss and gradient (`draws`, a list of
    each scene's p_losses draws, or `generator`'s), accumulated as the mean
    over grad_accum_step calls; on the last of them the mean over the ranks
    (under a process group) and the AdamW update. The step counter and the
    EMA advance every call. Runs the model under tc.train_fuse_mode.
    Returns the loss (a 0-d tensor), averaged over the ranks."""
    cfg = model.cfg
    if tc.train_fuse_mode != "model" and cfg.fuse_mode != tc.train_fuse_mode:
        model.cfg = dataclasses.replace(cfg, fuse_mode=tc.train_fuse_mode)
    try:
        opt = state.opt_state
        loss, grads = scene_batch_loss(model, batch, generator, draws)
        _accumulate(opt, grads)
        del grads  # not held through the update's temporaries
        k = max(tc.grad_accum_step, 1)
        emit = opt["mini_step"] == k - 1
        opt["mini_step"] = (opt["mini_step"] + 1) % k
        if emit:
            # the same tensors in the same order on every rank (a parameter no scene reached holds zeros)
            parallel.all_reduce_mean_(list(opt["acc"].values()))
            _optimizer_update(model, state, tc, opt["acc"])
            torch._foreach_zero_(list(opt["acc"].values()))
        if state.ema is not None:
            d = min(tc.ema_decay, (1.0 + state.step) / (10.0 + state.step))
            with torch.no_grad():
                emas = list(state.ema.values())
                torch._foreach_mul_(emas, d)
                torch._foreach_add_(emas, [state.params[n].to(e.dtype) for n, e in state.ema.items()],
                                    alpha=1.0 - d)
        state.step += 1
        loss = loss.detach()
        parallel.all_reduce_mean_([loss])
        return loss
    finally:
        model.cfg = cfg


def state_payload(state: TrainState, epoch: int) -> dict:
    """The TrainState and epoch as a checkpoint payload (tensors detached)."""
    det = lambda d: None if d is None else {n: t.detach() for n, t in d.items()}
    # between optimizer steps the accumulator is all zeros: it is left out
    skip = {"acc"} if state.opt_state["mini_step"] == 0 else set()
    opt = {k: det(v) if isinstance(v, dict) else v for k, v in state.opt_state.items() if k not in skip}
    payload = {"params": det(state.params), "opt_state": opt, "step": state.step, "epoch": epoch}
    if state.ema is not None:
        payload["ema"] = det(state.ema)
    return payload


def restore_state(model, state: TrainState, payload: dict) -> int:
    """Copy a checkpoint payload into `state` and the model's compute copies,
    in place. Returns the payload's epoch."""
    with torch.no_grad():
        for n, t in payload["params"].items():
            state.params[n].copy_(t)
        for k, v in payload["opt_state"].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    state.opt_state[k][n].copy_(t)
            else:
                state.opt_state[k] = v
        if "acc" not in payload["opt_state"]:
            for t in state.opt_state["acc"].values():
                t.zero_()
        if state.ema is not None and "ema" in payload:
            for n, t in payload["ema"].items():
                state.ema[n].copy_(t)
    load_params(model, state.params)
    state.step = int(payload["step"])
    return int(payload["epoch"])

