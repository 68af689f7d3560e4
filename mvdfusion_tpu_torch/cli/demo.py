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
        [--scene-batch N]
    torchrun --nproc-per-node G ... -m mvdfusion_tpu_torch.cli.demo \
        -c configs/gso.yaml --scene-batch N --multihost

Runs on the CUDA card unless `--device cpu` is given. `--scene-batch N`
samples N scenes a step in one sampler pass (pipeline/eval.py: one UNet call
over their CFG batch); the last batch wraps around the dataset and reports
no scene past --eval-num. `--multihost` takes the ranks from torchrun's
environment: where the ranks divide N, each takes N / ranks of a batch's
scenes (utils/common.py::split_list), else rank 0 runs them all, as the JAX
demo shards a batch over its cards or runs it on one. Each rank writes its
own scenes' artifacts, named by scene index; rank 0 gathers the metrics and
writes metrics.json in scene order. A scene's noise comes from a seed of
(--seed, scene index), so its result does not depend on the batch or the
rank that ran it. `--ckpt` (default: saver.ckpt_path) names a checkpoint of the
port's trainer: its directory (the file its `latest` pointer names) or one
`step_*` file; the demo restores its `params` (not the EMA), as the JAX
demo does. Where the path does not exist the model runs with random
weights from `--seed`. The reference's own weight files load in Python
through convert/reference.py (README).
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
                   help="scenes per sampler pass, sharded over the ranks where they divide it (1 = one at a time)")
    p.add_argument("--multihost", action="store_true",
                   help="take rank and world from torchrun's environment (run the same command on every host)")
    return p.parse_args(argv)


def scene_seed(seed: int, index: int) -> int:
    """A distinct noise seed for each (run seed, scene index)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def main(argv=None):
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from mvdfusion_tpu_torch import parallel

    if args.multihost:
        dev = parallel.init_distributed(torch.device(args.device).type)
    else:
        dev = torch.device(args.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    try:
        _demo(args, dev)
    finally:
        if args.multihost and dist.is_initialized():
            dist.destroy_process_group()


def _demo(args, dev):
    import torch

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.core.checkpoint import latest_checkpoint, restore_checkpoint
    from mvdfusion_tpu_torch.core.config import build_dataset, build_model_config, load_yaml
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, randomize_
    from mvdfusion_tpu_torch.ops.image import area_downsample
    from mvdfusion_tpu_torch.pipeline.eval import eval_scenes
    from mvdfusion_tpu_torch.pipeline.trainer import load_params
    from mvdfusion_tpu_torch.utils.common import split_list
    from mvdfusion_tpu_torch.utils.metrics import cross_view_consistency, perceptual_distance, psnr, ssim
    from mvdfusion_tpu_torch.utils.vis import save_eval_artifacts

    mesh = parallel.make_mesh(device=dev)
    nb = args.scene_batch
    if nb < 1:
        raise ValueError(f"--scene-batch {nb}: at least 1")
    # this rank's positions in each batch of nb scenes
    mine = split_list(list(range(nb)), mesh.world)[mesh.rank] if nb % mesh.world == 0 else (
        list(range(nb)) if mesh.rank == 0 else [])
    main0 = parallel.is_main()
    say = print if main0 else (lambda *a, **k: None)
    if dev.type == "cuda":
        from mvdfusion_tpu_torch.ops import _lib

        parallel.local_first(_lib.lib)  # one nvcc fan-out a host
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

    say(f"[demo] building the model ({'tiny' if args.tiny else 'full'}); {nb} scene(s) a batch over "
        f"{mesh.world} rank(s)")
    if mesh.world > 1:
        print(f"[demo] rank {mesh.rank} on {dev}: positions {mine} of each batch")
    t0 = time.time()
    model = randomize_(ViewFusion(mcfg, device=dev), seed=args.seed).eval()
    ckpt = args.ckpt or saver.get("ckpt_path")
    if ckpt and os.path.exists(str(ckpt)):
        path = latest_checkpoint(ckpt) if os.path.isdir(ckpt) else ckpt
        if path is None:
            raise FileNotFoundError(f"{ckpt}: a directory with no `latest` checkpoint")
        say(f"[demo] restoring {path}")
        load_params(model, restore_checkpoint(path)["params"])
    else:
        say("[demo] no checkpoint found — running with random weights")
    if inference.get("bf16_weights", True) and dev.type == "cuda":
        model.cast_for_inference()
    say(f"[demo] model ready {time.time() - t0:.1f}s")

    save_dir = os.path.join(saver.get("exp_dir", "demo/"), inference.get("vis_dir", "vis/"))
    os.makedirs(save_dir, exist_ok=True)
    t_start = time.time()
    scene_metrics = []

    def report(position, scene, out, done, seconds):
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
        scene_metrics.append((position, dict(
            scene=str(scene["idx"]), psnr=p, ssim=s, perceptual=percep, photo_mae=cons["photo_mae"],
            depth_agree_rate=cons["depth_agree_rate"], covis_frac=cons["covis_frac"],
        )))
        eta = (time.time() - t_start) / done * (eval_num - done)
        print(
            f"[demo] scene {scene['idx']} -> {jpg}  psnr {p:.2f} ssim {s:.3f} percep {percep:.3f}  "
            f"cons(photo {cons['photo_mae']:.4f} agree {cons['depth_agree_rate']:.3f} "
            f"covis {cons['covis_frac']:.3f})  {seconds['sample'] / steps:.4f} s/step, "
            f"{sum(seconds.values()):.2f} s a batch  [{done}/{eval_num}, eta {eta:.0f}s]"
        )

    done = 0
    for start in range(0, eval_num, nb):
        # the last batch wraps around the dataset; nothing past eval_num is reported
        positions = [start + j for j in mine]
        scenes = [dataset[p % len(dataset)] for p in positions]
        if not scenes:
            continue
        stack = {k: torch.as_tensor(np.stack([sc[k] for sc in scenes]), device=dev)
                 for k in ("images", "R", "T", "f", "c")}
        gens = [torch.Generator(device=dev).manual_seed(scene_seed(args.seed, sc["index"])) for sc in scenes]
        timings = []
        out = eval_scenes(model, stack["images"], stack["R"], stack["T"], stack["f"], stack["c"], input_idx,
                          target_idx, cfg_scale, num_steps=steps, generators=gens, timings=timings)
        out = {k: v.float().cpu().numpy() for k, v in out._asdict().items()}
        for j, (p, sc) in enumerate(zip(positions, scenes)):
            if p < eval_num:
                done += 1
                report(p, sc, {k: v[j] for k, v in out.items()}, done, timings[0])

    # every rank's metrics, in scene order
    ordered = [m for _, m in sorted((m for part in parallel.gather_objects(scene_metrics) for m in part),
                                    key=lambda pm: pm[0])]
    if ordered and main0:
        keys = ("psnr", "ssim", "perceptual", "photo_mae", "depth_agree_rate", "covis_frac")
        summary = {k: float(np.mean([m[k] for m in ordered])) for k in keys}
        print(
            f"[demo] mean over {len(ordered)} scenes: psnr {summary['psnr']:.2f} ssim {summary['ssim']:.3f} "
            f"percep {summary['perceptual']:.3f} cons(photo {summary['photo_mae']:.4f} "
            f"agree {summary['depth_agree_rate']:.3f} covis {summary['covis_frac']:.3f})"
        )
        path = os.path.join(save_dir, "metrics.json")
        with open(path, "w") as fp:
            json.dump({"scenes": ordered, "summary": summary}, fp, indent=2)
        print(f"[demo] metrics -> {path}")


if __name__ == "__main__":
    main()
