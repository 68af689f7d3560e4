"""Evaluation / demo entry point (counterpart of mvdfusion_tpu/cli/demo.py).

For each scene of the configured dataset: 1 input view and the config's
`inference.train_batch_size` target views (evenly spaced over the rig), an
eta=1 DDIM sample at CFG, the decoded views beside the ground truth, the
artifacts of the reference (strip jpg, gif, depth png/npy/gif), PSNR, SSIM,
the perceptual distance and the paper's cross-view consistency; at the end
`metrics.json` with per-scene values and their means.

Usage:
    python -m mvdfusion_tpu_torch.cli.demo -c configs/gso.yaml [--eval-num N]
        [--steps 50] [--cfg-scale 2.5] [--seed 0] [--tiny] [--device cuda]

Runs on the CUDA card unless `--device cpu` is given, one scene after
another. `--ckpt` (default: saver.ckpt_path) names a checkpoint of the
port's trainer: its directory (the file its `latest` pointer names) or one
`step_*` file; the demo restores its `params` (not the EMA), as the JAX
demo does. Where the path does not exist the model runs with random
weights from `--seed`. The reference's own weight files load in Python
through convert/reference.py (README). Multi-card evaluation is not ported
yet: `--multihost` and `--scene-batch` above 1 raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mvdfusion_tpu_torch eval/demo")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--eval-num", type=int, default=None, help="number of scenes (default: config)")
    p.add_argument("--steps", type=int, default=None, help="DDIM steps (default: config/50)")
    p.add_argument("--cfg-scale", type=float, default=None)
    p.add_argument("--ckpt", default=None,
                   help="the trainer's checkpoint directory or step_* file (default: saver.ckpt_path)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny model for smoke runs")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for a CPU run)")
    p.add_argument("--scene-batch", type=int, default=1,
                   help="scenes per sharded step over several cards (not ported yet: 1)")
    p.add_argument("--multihost", action="store_true", help="multi-host evaluation (not ported yet)")
    return p.parse_args(argv)


def scene_seed(seed: int, index: int) -> int:
    """A distinct noise seed for each (run seed, scene index)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def main(argv=None):
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError("multi-host evaluation is not ported yet (ROADMAP Queue 1: parallelism)")
    if args.scene_batch > 1:
        raise NotImplementedError("--scene-batch > 1 (scenes sharded over several cards) is not ported yet "
                                  "(ROADMAP Queue 1: parallelism)")
    import torch

    from mvdfusion_tpu_torch.core.checkpoint import latest_checkpoint, restore_checkpoint
    from mvdfusion_tpu_torch.core.config import build_dataset, build_model_config, load_yaml
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, randomize_
    from mvdfusion_tpu_torch.ops.image import area_downsample
    from mvdfusion_tpu_torch.pipeline.eval import eval_scenes
    from mvdfusion_tpu_torch.pipeline.trainer import load_params
    from mvdfusion_tpu_torch.utils.metrics import cross_view_consistency, perceptual_distance, psnr, ssim
    from mvdfusion_tpu_torch.utils.vis import save_eval_artifacts

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    cfg = load_yaml(args.config)
    inference = cfg.get("inference", {})
    saver = cfg.get("saver", {})
    n_targets = int(inference.get("train_batch_size", 15))
    cfg_scale = args.cfg_scale if args.cfg_scale is not None else float(inference.get("cfg_scale", 2.5))
    steps = args.steps if args.steps is not None else int(inference.get("num_ddim_steps", 50))
    eval_num = args.eval_num if args.eval_num is not None else int(inference.get("eval_num", 30))

    mcfg = build_model_config(cfg)
    if args.tiny:
        mcfg = mcfg.tiny()
    dataset = build_dataset(cfg)
    eval_num = min(eval_num, len(dataset))

    # view split: evenly spaced input + targets over the rig
    sel = np.linspace(0, dataset.n_views - 1, 1 + n_targets).astype(np.int64)
    input_idx = torch.as_tensor(sel[:1], device=dev)
    target_idx = torch.as_tensor(sel[1:], device=dev)

    print(f"[demo] building the model ({'tiny' if args.tiny else 'full'}) on {dev}...")
    t0 = time.time()
    model = randomize_(ViewFusion(mcfg, device=dev), seed=args.seed).eval()
    ckpt = args.ckpt or saver.get("ckpt_path")
    if ckpt and os.path.exists(str(ckpt)):
        path = latest_checkpoint(ckpt) if os.path.isdir(ckpt) else ckpt
        if path is None:
            raise FileNotFoundError(f"{ckpt}: a directory with no `latest` checkpoint")
        print(f"[demo] restoring {path}")
        load_params(model, restore_checkpoint(path)["params"])
    else:
        print("[demo] no checkpoint found — running with random weights")
    if inference.get("bf16_weights", True) and dev.type == "cuda":
        model.cast_for_inference()
    print(f"[demo] model ready {time.time() - t0:.1f}s")

    save_dir = os.path.join(saver.get("exp_dir", "demo/"), inference.get("vis_dir", "vis/"))
    os.makedirs(save_dir, exist_ok=True)
    t_start = time.time()
    scene_metrics = []

    def report(scene, out, done, seconds):
        jpg = save_eval_artifacts(
            save_dir, 0, int(scene["index"]), out["pred_rgb"], out["gt_rgb"],
            pred_depth=out["pred_depth"], input_depth=out["input_depth"], gt_depth=out["gt_depth"],
        )
        p = psnr(out["pred_rgb"], out["gt_rgb"])
        s = ssim(out["pred_rgb"], out["gt_rgb"])
        percep = perceptual_distance(out["pred_rgb"], out["gt_rgb"])
        # consistency of the generated RGB-D at latent resolution: the depth
        # lives there, the decoded RGB is area-downsampled to match
        factor = out["pred_rgb"].shape[1] // out["pred_depth"].shape[1]
        rgb_lr = area_downsample(torch.as_tensor(out["pred_rgb"]), factor).numpy()
        tgt = sel[1:]
        cons = cross_view_consistency(
            rgb_lr, out["pred_depth"], scene["R"][tgt], scene["T"][tgt], scene["f"][tgt], scene["c"][tgt],
        )
        scene_metrics.append(dict(
            scene=str(scene["idx"]), psnr=p, ssim=s, perceptual=percep, photo_mae=cons["photo_mae"],
            depth_agree_rate=cons["depth_agree_rate"], covis_frac=cons["covis_frac"],
        ))
        eta = (time.time() - t_start) / done * (eval_num - done)
        print(
            f"[demo] scene {scene['idx']} -> {jpg}  psnr {p:.2f} ssim {s:.3f} percep {percep:.3f}  "
            f"cons(photo {cons['photo_mae']:.4f} agree {cons['depth_agree_rate']:.3f} "
            f"covis {cons['covis_frac']:.3f})  {seconds['sample'] / steps:.4f} s/step, "
            f"{sum(seconds.values()):.2f} s  [{done}/{eval_num}, eta {eta:.0f}s]"
        )

    for i in range(eval_num):
        scene = dataset[i]
        one = {k: torch.as_tensor(scene[k][None], device=dev) for k in ("images", "R", "T", "f", "c")}
        gen = torch.Generator(device=dev).manual_seed(scene_seed(args.seed, scene["index"]))
        timings = []
        out = eval_scenes(model, one["images"], one["R"], one["T"], one["f"], one["c"], input_idx, target_idx,
                          cfg_scale, num_steps=steps, generators=[gen], timings=timings)
        report(scene, {k: v[0].float().cpu().numpy() for k, v in out._asdict().items()}, i + 1, timings[0])

    if scene_metrics:
        keys = ("psnr", "ssim", "perceptual", "photo_mae", "depth_agree_rate", "covis_frac")
        summary = {k: float(np.mean([m[k] for m in scene_metrics])) for k in keys}
        print(
            f"[demo] mean over {len(scene_metrics)} scenes: psnr {summary['psnr']:.2f} ssim {summary['ssim']:.3f} "
            f"percep {summary['perceptual']:.3f} cons(photo {summary['photo_mae']:.4f} "
            f"agree {summary['depth_agree_rate']:.3f} covis {summary['covis_frac']:.3f})"
        )
        path = os.path.join(save_dir, "metrics.json")
        with open(path, "w") as fp:
            json.dump({"scenes": scene_metrics, "summary": summary}, fp, indent=2)
        print(f"[demo] metrics -> {path}")


if __name__ == "__main__":
    main()
