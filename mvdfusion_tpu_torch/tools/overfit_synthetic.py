"""The learning proof: overfit ViewFusion on synthetic RGB-D scenes (counterpart
of tools/overfit_synthetic.py, with the port's modules).

No pretrained weights anywhere:

  stage 0  analytic multi-view dataset (data/synthetic.py): exact RGB-D
  stage 1  VAE pretrain (reconstruction), standing in for the pretrained SD
           VAE the reference loads: Adam over the vae.* parameters only,
           the gradient clipped to a global norm of 1, the lr decayed on a
           cosine to 5% of its peak
  stage 2  diffusion overfit through the port's trainer (pipeline/trainer.py:
           masked AdamW, shared-t p_losses, depth supervision), views 3 and
           11 held out of training entirely
  stage 3  eval: eta=1 DDIM on the held-out poses (and two trained ones)
           conditioned on view 0; novel-view PSNR against the analytic
           ground truth and against the random-weight floor, the sampled
           depth's error, the cross-view consistency, and a GridAttn
           ablation (the frustum zeroed) on the same weights and noise;
           image grids, the loss curve and report.json

    python -m mvdfusion_tpu_torch.tools.overfit_synthetic --out DIR
        [--model tiny|small|medium] [--family spheres|mixed] [--textured]
        [--steps N] [--vae-steps N] [--quick] [--eval-only] [--device cuda|cpu]

Runs on the card unless --device says otherwise. The view picks and the VAE
batches are numpy draws from the JAX tool's seeds, so both tools take the
same ones; the model's initial weights follow flax's initializers
(init_params), and the noise comes from torch.Generators seeded from the
seed. Training keeps the sites and GridAttn on their module paths
(TrainConfig.train_fuse_mode "never"); sampling takes the kernels wherever
their gates open. The EMA parameters are saved with torch.save as
trained_params.pt in the output directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np

# views never used for training (neither input nor target): novel poses at eval time
HELDOUT_VIEWS = (3, 11)
EVAL_INPUT_VIEW = 0
PARAMS_FILE = "trained_params.pt"


@dataclasses.dataclass
class OverfitArgs:
    scenes: int = 4
    image_size: int = 64
    vae_steps: int = 1500
    steps: int = 6000
    eval_ddim_steps: int = 50
    n_targets: int = 5
    vae_lr: float = 2e-3
    lr: float = 3e-4
    seed: int = 0
    out: str = "artifacts/overfit_torch"
    log_every: int = 200
    # "tiny" = the test config; "small" = 2x width where it matters; "medium" one notch up
    model: str = "tiny"
    # eval sampling seed base (scene s samples from eval_seed + s)
    eval_seed: int = 1000
    # analytic albedo bands on the primitives (data/synthetic.py)
    textured: bool = False
    # primitive family (data/synthetic.py): "spheres" or "mixed"
    family: str = "spheres"
    device: str = "cuda"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(args: OverfitArgs):
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_dataset(args: OverfitArgs):
    """The synthetic scenes and their arrays stacked over scenes (numpy)."""
    from mvdfusion_tpu_torch.data.synthetic import SyntheticScenes

    ds = SyntheticScenes(
        n_scenes=args.scenes, image_size=args.image_size, seed=args.seed,
        textured=args.textured, family=args.family,
    )
    scenes = [ds[i] for i in range(len(ds))]
    batch = {k: np.stack([s[k] for s in scenes]) for k in ("images", "R", "T", "f", "c", "depths")}
    return ds, batch


def model_config(model: str):
    """ViewFusionConfig().tiny(), or one of the two wider notches (fp32)."""
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusionConfig

    cfg = ViewFusionConfig().tiny()
    widths = {
        "tiny": {},
        "small": dict(unet_model_channels=64, viewattn_hidden=64, viewattn_layers=3, context_dim=128,
                      time_embed_dim=64),
        "medium": dict(unet_model_channels=96, viewattn_hidden=96, viewattn_layers=3, context_dim=192,
                       time_embed_dim=96),
    }
    if model not in widths:
        raise ValueError(f"unknown --model {model!r}")
    return dataclasses.replace(cfg, **widths[model])


def build_model(args: OverfitArgs):
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion

    cfg = model_config(args.model)
    assert args.image_size == cfg.latent_size * 4, "the tiny VAE downsamples 4x"
    return ViewFusion(cfg, device=_device(args)), cfg


# flax paths whose kernels the JAX model initialises to zero: the UNet's output
# conv, its ResBlocks' second conv, its sites' proj_out, and the DiT's adaLN
def _zero_kernel(path) -> bool:
    if "adaLN" in path:
        return True
    return path[0] == "unet" and (path[-2] in ("conv_out", "proj_out", "conv2"))


def init_params(model, seed: int) -> None:
    """Initialise every parameter in place by the rule flax's initializers
    apply to the JAX model (the JAX tool's init_params): kernels lecun-normal
    (a normal truncated at 2 sigma, variance 1 / fan_in), zero where the JAX
    model zero-initialises them (_zero_kernel), cc_projection's first layer
    eye / zero; biases 0 and norm scales 1; CLIP's class embedding and
    projection N(0, width^-1), its positional embedding N(0, 0.01^2). The
    draws come from a torch.Generator seeded with `seed`, on the parameters'
    device: the same distributions as the JAX model's init, not its values."""
    import torch

    from mvdfusion_tpu_torch.convert.from_jax import viewfusion_table

    table = viewfusion_table(model.cfg)
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    d = model.cfg.context_dim
    first_cc = "cc_projection.0.weight" if model.cfg.embed_camera_pose else "cc_projection.weight"
    with torch.no_grad():
        for name, p in model.named_parameters():
            paths, _ = table[name]
            leaf = paths[0][-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif name == first_cc:
                p.zero_()
                p[:d, :d] = torch.eye(d)
            elif leaf == "kernel" and _zero_kernel(paths[0]):
                p.zero_()
            elif leaf == "kernel":
                std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
                torch.nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
            elif leaf in ("class_embedding", "proj", "positional_embedding"):
                std = 0.01 if leaf == "positional_embedding" else model.cfg.clip_width ** -0.5
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * std)
            else:
                raise KeyError(f"{name}: no initializer for flax leaf {leaf!r}")


def _recon(model, im):
    return model.decode_latents(model.encode_images(im))


# --------------------------------------------------------------- stage 1: VAE
def pretrain_vae(model, batch, args: OverfitArgs):
    """Reconstruction-train the vae.* parameters only (everything else
    frozen): Adam (0.9, 0.999, eps 1e-8) after a clip to global norm 1.0
    over those parameters, lr on optax.cosine_decay_schedule(vae_lr,
    vae_steps, alpha=0.05). Each step's 16 images (all, if fewer) are a
    numpy draw from default_rng(seed + 17), as the JAX tool's. Returns the
    reconstruction PSNR over the whole set and the losses of the steps."""
    import torch

    dev = next(model.parameters()).device
    all_images = torch.as_tensor(batch["images"].reshape(-1, *batch["images"].shape[2:]), device=dev)
    named = [(n, p) for n, p in model.named_parameters()]
    for n, p in named:
        p.requires_grad_(n.startswith("vae."))
    params = [p for n, p in named if n.startswith("vae.")]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    b1, b2, eps, alpha = 0.9, 0.999, 1e-8, 0.05
    decay = max(args.vae_steps, 1)
    rng = np.random.default_rng(args.seed + 17)
    n = all_images.shape[0]
    t0 = time.time()
    losses = []
    for i in range(args.vae_steps):
        idx = rng.choice(n, size=min(16, n), replace=False)
        im = all_images[torch.as_tensor(idx, device=dev)]
        loss = torch.mean((_recon(model, im) - im) ** 2)
        grads = list(torch.autograd.grad(loss, params))
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            if not bool(norm < 1.0):
                grads = torch._foreach_div(grads, norm)
            lr = args.vae_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(i, decay) / decay)) + alpha)
            c1, c2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
            # per element: m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p -= lr (m / c1) / (sqrt(v / c2) + eps)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            u = torch._foreach_div(mu, c1)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            torch._foreach_mul_(u, lr)
            torch._foreach_sub_(params, u)
        losses.append(loss.item())
        if i % args.log_every == 0 or i == args.vae_steps - 1:
            _log(f"[vae {i}/{args.vae_steps}] recon mse {losses[-1]:.5f} ({time.time() - t0:.0f}s)")
    for p in params:
        p.requires_grad_(False)
    with torch.no_grad():
        mse = float(torch.mean((_recon(model, all_images) - all_images) ** 2))
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    _log(f"[vae] final recon PSNR {psnr:.2f} dB")
    return psnr, np.asarray(losses)


# --------------------------------------------------------- stage 2: diffusion
def train_config(args: OverfitArgs):
    """The JAX tool's trainer: cosine to 10% over the run, clip 1.0, the
    non-finite skip, a 0.999 EMA, the whole UNet trained."""
    from mvdfusion_tpu_torch.pipeline.trainer import TrainConfig

    return TrainConfig(
        lr=args.lr, lr_schedule="cosine", lr_decay_steps=args.steps, lr_alpha=0.1,
        finetune_unet=True, grad_clip=1.0, skip_nonfinite=True, ema_decay=0.999,
    )


def view_picks(args: OverfitArgs, rng):
    """One step's input and target views of every scene from the train
    split: (scenes, 1) and (scenes, n_targets)."""
    train_views = np.asarray([v for v in range(16) if v not in HELDOUT_VIEWS], np.int32)
    ii, ti = [], []
    for _ in range(args.scenes):
        pick = rng.choice(train_views, size=1 + args.n_targets, replace=False)
        ii.append(pick[:1])
        ti.append(pick[1:])
    return np.stack(ii), np.stack(ti)


def train_diffusion(model, batch, args: OverfitArgs):
    """args.steps calls of the port's train step on every scene, the views
    from default_rng(seed + 23), the draws from a torch.Generator seeded
    with seed + 29. Leaves the EMA parameters in the model; returns the
    TrainState, the losses and the seconds of the steps."""
    import torch

    from mvdfusion_tpu_torch.pipeline.trainer import eval_params, init_train_state, load_params, train_step

    dev = next(model.parameters()).device
    tc = train_config(args)
    state = init_train_state(model, tc)
    tbatch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    rng = np.random.default_rng(args.seed + 23)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    losses = []
    _sync(dev)
    t0 = time.time()
    for i in range(args.steps):
        ii, ti = view_picks(args, rng)
        sbatch = dict(tbatch, input_idx=torch.as_tensor(ii, dtype=torch.long, device=dev),
                      target_idx=torch.as_tensor(ti, dtype=torch.long, device=dev))
        losses.append(float(train_step(model, state, sbatch, tc, generator=gen)))
        if i % args.log_every == 0 or i == args.steps - 1:
            w = np.mean(losses[-50:])
            _log(f"[diff {i}/{args.steps}] loss {losses[-1]:.4f} (avg50 {w:.4f}) ({time.time() - t0:.0f}s)")
        if i and i % 2000 == 0:
            save_params(eval_params(state), os.path.join(args.out, PARAMS_FILE))
    _sync(dev)
    seconds = time.time() - t0
    load_params(model, eval_params(state))
    for p in model.parameters():
        p.requires_grad_(False)
    return state, np.asarray(losses), seconds


# -------------------------------------------------------------- stage 3: eval
def evaluate(model, batch, args: OverfitArgs, eval_views=None, tag="eval", noise=None, scenes=None):
    """eta=1 DDIM of eval_views (default: the held-out views, then 5 and 13)
    conditioned on EVAL_INPUT_VIEW for every scene (or `scenes`), the carry
    clamped to 6 x max(1, max|input latent|). Scene s draws its noise from a
    torch.Generator seeded with eval_seed + s, or takes noise[s] (a dict of
    ddim_sample's init_noise, step_noise, jitter_noise). Returns the views
    and a dict per scene: rgb, gt, depth_pred, depth_gt, psnr (per view),
    depth_mae, consistency, consistency_gt."""
    import torch

    from mvdfusion_tpu_torch.ops.image import area_downsample
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample
    from mvdfusion_tpu_torch.utils.common import unnormalize
    from mvdfusion_tpu_torch.utils.metrics import cross_view_consistency
    from mvdfusion_tpu_torch.utils.metrics import psnr as np_psnr

    if eval_views is None:
        eval_views = list(HELDOUT_VIEWS) + [5, 13]
    eval_views = np.asarray(eval_views, np.int64)
    dev = next(model.parameters()).device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    factor = args.image_size // model.cfg.latent_size
    results = []
    for s in range(args.scenes) if scenes is None else scenes:
        with torch.no_grad():
            _, cams, in_lat, in_cams, clip_v = model.prepare_batch(
                t(batch["images"][s]), t(batch["R"][s]), t(batch["T"][s]), t(batch["f"][s]), t(batch["c"][s]),
                t([EVAL_INPUT_VIEW]), t(eval_views), depths=t(batch["depths"][s]),
            )
            # stability rail: the identity for healthy trajectories, arrests from-scratch blow-ups
            bound = 6.0 * max(1.0, in_lat.abs().max().item())
            gen = torch.Generator(device=dev).manual_seed(args.eval_seed + s)
            res = ddim_sample(model, cams, in_lat, in_cams, clip_v, 1.0, num_steps=args.eval_ddim_steps,
                              generator=gen, x_clip=bound, **(noise[s] if noise is not None else {}))
            rgb = model.decode_latents(res.latents[..., :4]).cpu().numpy()
            # the sampled depth channel lives in normalize()d space
            depth_pred = unnormalize(res.latents[..., 4:5]).cpu().numpy()
        gt = batch["images"][s][eval_views]
        depth_gt = area_downsample(torch.as_tensor(batch["depths"][s][eval_views]), factor).numpy()
        scene_psnr = [np_psnr(rgb[i], gt[i]) for i in range(len(eval_views))]
        # cross-view consistency of the generated RGB-D at latent resolution,
        # and the analytic ground truth's on the same poses (its ceiling)
        cams_np = tuple(batch[k][s][eval_views] for k in ("R", "T", "f", "c"))
        rgb_lr = area_downsample(torch.as_tensor(rgb), factor).numpy()
        consistency = cross_view_consistency(rgb_lr, depth_pred, *cams_np)
        gt_lr = area_downsample(torch.as_tensor(gt), factor).numpy()
        consistency_gt = cross_view_consistency(gt_lr, depth_gt, *cams_np)
        results.append(dict(
            rgb=rgb, gt=gt, depth_pred=depth_pred, depth_gt=depth_gt, psnr=scene_psnr,
            depth_mae=float(np.mean(np.abs(depth_pred - depth_gt))),
            consistency=consistency, consistency_gt=consistency_gt,
        ))
        _log(
            f"[{tag} scene {s}] psnr {['%.1f' % p for p in scene_psnr]} "
            f"depth_mae {results[-1]['depth_mae']:.4f} "
            f"cons(photo {consistency['photo_mae']:.4f} agree "
            f"{consistency['depth_agree_rate']:.3f} covis {consistency['covis_frac']:.3f}; "
            f"GT ceiling photo {consistency_gt['photo_mae']:.4f})"
        )
    return eval_views, results


def save_params(params: dict, path: str) -> None:
    """name -> tensor, written with torch.save (on the CPU)."""
    import torch

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({n: t.detach().cpu() for n, t in params.items()}, path)
    _log(f"[ckpt] saved {len(params)} tensors -> {path}")


def load_saved_params(model, path: str) -> None:
    import torch

    from mvdfusion_tpu_torch.pipeline.trainer import load_params

    load_params(model, torch.load(path, map_location="cpu"))


def save_artifacts(eval_views, results, losses, out_dir: str, tag: str):
    """{tag}_grid.png (rows: GT rgb / sampled rgb / GT depth / sampled depth;
    a column per eval view, the scenes side by side) and, given losses,
    loss_curve.npy."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)

    def up(d):  # latent-res depth -> image-res grayscale, nearest
        d = np.clip(d[..., 0], 0.0, 1.0)
        k = results[0]["gt"].shape[1] // d.shape[0]
        return np.repeat(np.repeat(d, k, 0), k, 1)[..., None].repeat(3, -1)

    rows = []
    for r in results:
        cells = [np.concatenate([r["gt"][i], r["rgb"][i], up(r["depth_gt"][i]), up(r["depth_pred"][i])], axis=0)
                 for i in range(len(eval_views))]
        rows.append(np.concatenate(cells, axis=1))
    grid = np.concatenate(rows, axis=1)
    path = os.path.join(out_dir, f"{tag}_grid.png")
    Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(path)
    _log(f"[artifacts] wrote {path} (rows: GT rgb / sampled rgb / GT depth / sampled depth)")
    if losses is not None and len(losses):
        np.save(os.path.join(out_dir, "loss_curve.npy"), losses)


def loss_windows(curve, reference, every: int = 500, width: int = 100):
    """Rows (step, mean of `curve`, mean of `reference`) over the `width`
    steps from each multiple of `every` that both curves reach: two runs'
    losses at the same step indices (np.load of each loss_curve.npy)."""
    n = min(len(curve), len(reference))
    return [(i, float(np.mean(curve[i:i + width])), float(np.mean(reference[i:i + width])))
            for i in range(0, n - width + 1, every)]


def _mean_psnr(results) -> float:
    return float(np.mean([p for r in results for p in r["psnr"]]))


def run(args: OverfitArgs, eval_only: bool = False) -> dict:
    """The four stages; writes the grids, the loss curve, the EMA parameters
    and report.json (the JAX tool's keys, plus the device and the seconds
    of each stage) under args.out, and returns the report."""
    import torch

    dev = _device(args)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    _log(f"[overfit] device: {dev} ({card})")
    t_start = time.time()
    _, batch = build_dataset(args)
    model, cfg = build_model(args)
    init_params(model, args.seed)
    ckpt = os.path.join(args.out, PARAMS_FILE)
    if eval_only:
        # sample the saved EMA parameters again without retraining
        load_saved_params(model, ckpt)
        eval_views, trained = evaluate(model, batch, args, tag="trained")
        save_artifacts(eval_views, trained, None, args.out, "trained")
        psnr = _mean_psnr(trained)
        _log(f"[eval-only] trained psnr {psnr:.2f}")
        return dict(trained_psnr=psnr)

    _sync(dev)
    t0 = time.time()
    vae_psnr, _ = pretrain_vae(model, batch, args)
    _sync(dev)
    vae_s = time.time() - t0

    # random-diffusion floor: pretrained VAE + untrained UNet / GridAttn
    t0 = time.time()
    eval_views, floor = evaluate(model, batch, args, tag="floor")
    floor_psnr = _mean_psnr(floor)
    floor_dmae = float(np.mean([r["depth_mae"] for r in floor]))
    eval_s = time.time() - t0

    state, losses, train_s = train_diffusion(model, batch, args)
    save_params({n: p for n, p in model.named_parameters()}, ckpt)

    t0 = time.time()
    eval_views, trained = evaluate(model, batch, args, tag="trained")
    trained_psnr = _mean_psnr(trained)
    trained_dmae = float(np.mean([r["depth_mae"] for r in trained]))
    heldout_psnr = float(np.mean([r["psnr"][i] for r in trained for i in range(len(eval_views))
                                  if int(eval_views[i]) in HELDOUT_VIEWS]))

    # GridAttn ablation: the same trained parameters and seeds, the frustum zeroed
    model.cfg = dataclasses.replace(cfg, ablate_frustum=True)
    try:
        _, ablated = evaluate(model, batch, args, tag="ablated")
    finally:
        model.cfg = cfg
    eval_s += time.time() - t0

    save_artifacts(eval_views, floor, None, args.out, "floor")
    save_artifacts(eval_views, trained, losses, args.out, "trained")
    save_artifacts(eval_views, ablated, None, args.out, "ablated")

    def agg_consistency(results, key="consistency"):
        ks = ("photo_mae", "depth_agree_rate", "covis_frac")
        return {k: float(np.mean([r[key][k] for r in results])) for k in ks}

    report = dict(
        vae_recon_psnr=vae_psnr,
        floor_psnr=floor_psnr,
        trained_psnr=trained_psnr,
        heldout_psnr=heldout_psnr,
        floor_depth_mae=floor_dmae,
        trained_depth_mae=trained_dmae,
        loss_first_100=float(np.mean(losses[:100])),
        loss_last_100=float(np.mean(losses[-100:])),
        steps=args.steps,
        vae_steps=args.vae_steps,
        eval_views=[int(v) for v in eval_views],
        heldout_views=list(HELDOUT_VIEWS),
        model=args.model,
        scenes=args.scenes,
        textured=args.textured,
        family=args.family,
        consistency=agg_consistency(trained),
        consistency_ablated=agg_consistency(ablated),
        consistency_gt_ceiling=agg_consistency(trained, "consistency_gt"),
        ablated_psnr=_mean_psnr(ablated),
        ablated_depth_mae=float(np.mean([r["depth_mae"] for r in ablated])),
        device=card,
        skipped_steps=int(state.opt_state["total_notfinite"]),
        seconds=dict(vae=vae_s, train=train_s, train_per_step=train_s / max(args.steps, 1), eval=eval_s,
                     wall=time.time() - t_start),
    )
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "report.json"), "w") as fp:
        json.dump(report, fp, indent=2)
    _log(f"[overfit] report: {json.dumps(report, indent=2)}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description="the learning proof on synthetic scenes")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--vae-steps", type=int, default=1500)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--eval-ddim-steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/overfit_torch")
    ap.add_argument("--quick", action="store_true", help="smoke sizes (2 scenes, 60 + 150 steps, 8 DDIM steps)")
    ap.add_argument("--eval-only", action="store_true", help="skip training; evaluate the saved trained_params.pt")
    ap.add_argument("--eval-seed", type=int, default=1000, help="eval sampling seed base")
    ap.add_argument("--model", default="tiny", choices=("tiny", "small", "medium"))
    ap.add_argument("--textured", action="store_true")
    ap.add_argument("--family", default="spheres", choices=("spheres", "mixed"))
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for a CPU run)")
    a = ap.parse_args(argv)
    args = OverfitArgs(
        scenes=a.scenes, vae_steps=a.vae_steps, steps=a.steps, eval_ddim_steps=a.eval_ddim_steps, lr=a.lr,
        seed=a.seed, out=a.out, model=a.model, eval_seed=a.eval_seed, textured=a.textured, family=a.family,
        device=a.device,
    )
    if a.quick:
        args = dataclasses.replace(args, scenes=2, vae_steps=60, steps=150, eval_ddim_steps=8, log_every=20)
    return run(args, eval_only=a.eval_only)


if __name__ == "__main__":
    main()
