"""Training entry point (counterpart of mvdfusion_tpu/cli/train.py).

    python -m mvdfusion_tpu_torch.cli.train -c configs/train.yaml [--tiny]
        [--max-steps N] [--scenes-per-chip N] [--seed N] [--device cuda|cpu]
        [--dp N] [--profile DIR]
    torchrun --nnodes H --nproc-per-node G ... -m mvdfusion_tpu_torch.cli.train \
        -c configs/train.yaml --multihost

A step is one call of the train step on `scenes_per_chip` scenes a rank;
with grad_accum_step k the optimizer updates every k steps. `--dp N` (by
default every visible card, 1 on the CPU) runs N ranks on this host, one
card each (parallel.spawn); `--multihost` takes the ranks from torchrun's
environment on every host instead. A step's global batch is dp x
scenes_per_chip scenes from one sampler; rank r trains on positions [r spc,
(r+1) spc) of it, its prefetch thread loading only those, and the trainer
averages the gradient over the ranks once per optimizer step
(pipeline/trainer.py). Rank 0 alone writes checkpoints (torch.save: the
masters, the optimizer state, step and epoch) to
<exp_dir>/ckpt/step_{n:08d} with a `latest` pointer, the loss plot and the
vis grid, and prints the logs; a run finding a checkpoint resumes from it on
every rank and skips the batches its epoch already consumed. Each scene's
draws (timestep, noise, jitter, condition dropout) come from a seed of
(seed, step, 0, its position in the global batch), and each batch's view
splits from (seed, epoch, batch), so a resumed run takes the same steps as
an unbroken one and a scene's draws do not depend on the number of ranks.
saver.{print,save,vis,loss}_interval count steps; the vis grid is a full
DDIM sample at CFG 1 on the batch's first scene, or with saver.regression
the one-step preview (apply_model at t = T-1 on the clean latents, then
predict_start_from_noise). --profile writes a torch.profiler trace of
steps 10-13 to DIR. main returns the model and its TrainState (None in the
process that spawned the ranks). --tp > 1 raises: tensor parallelism is
not ported.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

_TP = "(ROADMAP Queue 1: tensor and view parallelism)"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="mvdfusion_tpu_torch training")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel ranks (default: every visible card on cuda, 1 on the cpu)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel width (not ported: 1)")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--scenes-per-chip", type=int, default=None,
                   help="scenes per rank per step (overrides trainer.scenes_per_chip)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for a CPU run)")
    p.add_argument("--profile", default=None, help="write a torch.profiler trace of steps 10-13 to this dir")
    p.add_argument("--multihost", action="store_true",
                   help="take rank and world from torchrun's environment (run the same command on every host)")
    return p.parse_args(argv)


def _seed(*key) -> int:
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


def main(argv=None):
    args = parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(f"--tp {args.tp}: tensor parallelism is not ported {_TP}")
    import torch

    from mvdfusion_tpu_torch import parallel

    device_type = torch.device(args.device).type
    if args.multihost:
        return _run_rank(args)
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    dp = args.dp if args.dp is not None else (torch.cuda.device_count() if device_type == "cuda" else 1)
    if dp > 1:
        parallel.spawn(_run_rank, dp, (argparse.Namespace(**{**vars(args), "dp": dp}),))
        return None
    return _train(args, torch.device(args.device))


def _run_rank(args):
    """One rank of a data-parallel run (torchrun's or parallel.spawn's)."""
    import torch
    import torch.distributed as dist

    from mvdfusion_tpu_torch import parallel

    try:
        return _train(args, parallel.init_distributed(torch.device(args.device).type))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev):
    import torch

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.core.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from mvdfusion_tpu_torch.core.config import build_dataset, build_model_config, build_train_config, load_yaml
    from mvdfusion_tpu_torch.data.prefetch import PrefetchIterator
    from mvdfusion_tpu_torch.data.sampler import StatefulShardedSampler
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, randomize_
    from mvdfusion_tpu_torch.pipeline.trainer import (
        eval_params, init_train_state, load_params, restore_state, state_payload, train_step,
    )
    from mvdfusion_tpu_torch.utils.vis import save_loss_plot

    mesh = parallel.make_mesh(dp=args.dp, tp=args.tp, device=dev)
    if mesh.dp != mesh.world:
        raise ValueError(f"--dp {mesh.dp} over {mesh.world} ranks: every rank is a data-parallel rank")
    rank, main0 = mesh.rank, parallel.is_main()
    say = print if main0 else (lambda *a, **k: None)
    if dev.type == "cuda":
        from mvdfusion_tpu_torch.ops import _lib

        parallel.local_first(_lib.lib)  # one nvcc fan-out a host
    cfg = load_yaml(args.config)
    trainer_cfg = cfg.get("trainer", {})
    saver = cfg.get("saver", {})
    epochs = int(trainer_cfg.get("epochs", 200))
    n_targets = int(trainer_cfg.get("train_batch_size", 5))
    random_views = bool(trainer_cfg.get("random_views", True))
    spc = args.scenes_per_chip or int(trainer_cfg.get("scenes_per_chip", 1))

    mcfg = build_model_config(cfg)
    if args.tiny:
        mcfg = mcfg.tiny()
    tc = build_train_config(cfg)
    dataset = build_dataset(cfg)
    n_views = dataset[0]["images"].shape[0]
    say(f"[train] dp {mesh.dp} x {spc} scene(s)/step, grad_accum_step {tc.grad_accum_step}")
    print(f"[train] rank {rank}/{mesh.world} on {dev}")

    def sync_start():
        """Every rank starts from rank 0's masters (and EMA)."""
        if mesh.world > 1:
            parallel.broadcast_(list(state.params.values()) + list((state.ema or {}).values()))
            load_params(model, state.params)

    t0 = time.time()
    model = randomize_(ViewFusion(mcfg, device=dev), seed=args.seed)
    state = init_train_state(model, tc)
    sync_start()
    say(f"[train] init {time.time() - t0:.1f}s")

    exp_dir = saver.get("exp_dir", "runs/")
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    start_epoch = 0
    parallel.barrier()
    latest = latest_checkpoint(ckpt_dir)
    if latest:
        t0 = time.time()
        start_epoch = restore_state(model, state, restore_checkpoint(latest))
        sync_start()
        print(f"[train] rank {rank}: resumed from {latest} ({time.time() - t0:.1f}s)")
    start_step = state.step
    mine = slice(rank * spc, (rank + 1) * spc)  # this rank's positions in a step's global batch

    def view_split(rng):
        if random_views:
            perm = rng.permutation(n_views)
        else:
            perm = np.linspace(0, n_views - 1, 1 + n_targets).astype(np.int64)
        return perm[:1].astype(np.int64), perm[1 : 1 + n_targets].astype(np.int64)

    load_keys = ("images", "R", "T", "f", "c") + (("depths",) if "depths" in dataset[0] else ())

    def make_batch(item):
        epoch, index, scene_ids = item
        rng = np.random.default_rng(_seed(args.seed, epoch, index))
        splits = [view_split(rng) for _ in scene_ids][mine]  # the whole batch's splits, as on one rank
        scenes = [dataset[int(s)] for s in scene_ids[mine]]
        batch = {k: torch.as_tensor(np.stack([np.asarray(s[k], np.float32) for s in scenes])) for k in load_keys}
        batch["input_idx"] = torch.as_tensor(np.stack([a for a, _ in splits]))
        batch["target_idx"] = torch.as_tensor(np.stack([b for _, b in splits]))
        return {k: v.to(dev, non_blocking=True) for k, v in batch.items()}

    print_interval = int(saver.get("print_interval", 100))
    save_interval = int(saver.get("save_interval", 2000))
    vis_interval = int(saver.get("vis_interval", 0))  # 0 = off
    vis_ddim_steps = int(saver.get("vis_ddim_steps", 50))
    vis_dir = os.path.join(exp_dir, saver.get("vis_dir", "vis/"))
    loss_interval = int(saver.get("loss_interval", print_interval))
    loss_dir = os.path.join(exp_dir, saver.get("loss_dir", "loss/"))
    regression = bool(saver.get("regression", False))

    def visualize(batch, step):
        """The sample grid of the batch's first scene with the eval
        parameters (the EMA where tracked), rows [noise | pred | gt | pred
        depth | gt depth]; slot 0 of the noise row shows the ground truth."""
        from mvdfusion_tpu_torch.core.schedule import predict_start_from_noise
        from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample
        from mvdfusion_tpu_torch.utils.vis import save_train_vis_grid

        live = None
        if state.ema is not None:
            live = {n: p.detach().clone() for n, p in model.named_parameters()}
            load_params(model, eval_params(state))
        g = torch.Generator(device=dev).manual_seed(_seed(args.seed, step, 1))
        try:
            with torch.no_grad():
                lat, cams, in_lat, in_cams, clip_v = model.prepare_batch(
                    *(batch[k][0] for k in ("images", "R", "T", "f", "c", "input_idx", "target_idx")))
                if regression:
                    t = torch.full((lat.shape[0],), mcfg.timesteps - 1, dtype=torch.long, device=dev)
                    jitter = torch.randn(*lat.shape[:3], mcfg.n_pts_per_ray, generator=g, device=dev)
                    eps = model.apply_model(lat, cams, in_lat, in_cams, clip_v, t, jitter)
                    pred = predict_start_from_noise(model.sched(dev), lat, eps, t)
                else:
                    pred = ddim_sample(model, cams, in_lat, in_cams, clip_v, 1.0, num_steps=vis_ddim_steps,
                                       generator=g).latents
                noise = torch.randn(lat[..., :4].shape, generator=g, device=dev)
                noise[0] = lat[0, ..., :4]
                rgb = lambda z: model.decode_latents(z).cpu().numpy()
                unnorm = lambda d: np.clip((d.float().cpu().numpy() + 1) / 2, 0, 1)
                save_train_vis_grid(
                    os.path.join(vis_dir, f"{step:07d}.jpg"), rgb(noise), rgb(pred[..., :4]), rgb(lat[..., :4]),
                    unnorm(pred[..., 4:]), unnorm(lat[..., 4:]), input_rgb=rgb(in_lat[..., :4]),
                    input_depth=unnorm(in_lat[..., 4:]), concat_input=bool(saver.get("concat_input", False)),
                )
        finally:
            if live is not None:
                load_params(model, live)
        print(f"[train] wrote visual sample grid @ step {step}")

    sampler = StatefulShardedSampler(len(dataset), batch_size=mesh.dp * spc, seed=args.seed, start_step=start_step)
    losses, loss_history = [], []
    step = start_step
    t_last = time.time()
    prof = None
    for epoch in range(start_epoch, epochs):
        items = [(epoch, sampler._offset + i, ids) for i, ids in enumerate(sampler.epoch(epoch))]
        for batch in PrefetchIterator(items, make_batch, depth=2):
            if args.profile and main0 and step - start_step == 10:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                              + ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else []))
                prof.__enter__()
            draws = [model.loss_draws(batch["target_idx"].shape[1], dev,
                                      torch.Generator(device=dev).manual_seed(_seed(args.seed, step, 0, p)))
                     for p in range(mine.start, mine.stop)]
            loss = train_step(model, state, batch, tc, draws=draws)
            step += 1
            if prof is not None and step - start_step == 13:
                prof.__exit__(None, None, None)
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
                prof = None
                print(f"[train] profiler trace written to {args.profile}")
            losses.append(float(loss))
            losses = losses[-100:]
            avg = sum(losses) / len(losses)
            if step % loss_interval == 0 and main0:
                loss_history.append(avg)
                save_loss_plot(os.path.join(loss_dir, "loss.png"), loss_history, loss_interval)
            if step % print_interval == 0 and main0:
                dt = (time.time() - t_last) / print_interval
                t_last = time.time()
                print(f"[train] epoch {epoch} step {step} loss {avg:.4f} ({dt:.2f}s/it)")
            if vis_interval and step % vis_interval == 0 and main0:
                visualize(batch, step)
            if step % save_interval == 0 and main0:
                # the epoch of the next step: a save at an epoch's end resumes at the next one's start
                t0 = time.time()
                save_checkpoint(ckpt_dir, step, state_payload(state, epoch + (step % sampler.steps_per_epoch == 0)))
                print(f"[train] saved checkpoint @ step {step} ({time.time() - t0:.1f}s)")
            if args.max_steps and step - start_step >= args.max_steps:
                say("[train] reached max steps")
                return model, state
        sampler.reset_offset()
    return model, state


if __name__ == "__main__":
    main()
