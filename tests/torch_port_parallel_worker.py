"""One rank of tests/test_torch_port_parallel.py's two-process gloo train
step (started with torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).

    python tests/torch_port_parallel_worker.py IN.pt OUT_PREFIX

IN.pt holds a 2-scene batch and each scene's p_losses draws. Rank r builds
the tiny model (fp32, drop_conditions, randomize_ seed 0) and (at world
size 1, on both scenes with both draws, step 1 only):
  1. takes scene r of the batch with its draws through one train_step
     (finetune_unet: every UNet leaf trainable; grad_accum_step 1), recording the gradient the optimizer reads;
  2. from the same start at grad_accum_step 2, two calls on scene r with
     other draws, recording the gradient at the optimizer step, beside the
     running mean of each call's gradient averaged over the ranks first.
Writes OUT_PREFIX{r}.pt: the loss, the gradients and the masters of 1, and
the two gradients of 2.
"""

import dataclasses
import sys


def main() -> None:
    inp, out = sys.argv[1], sys.argv[2]

    import torch

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
    from mvdfusion_tpu_torch.pipeline import trainer

    dev = parallel.init_distributed("cpu")
    mesh = parallel.make_mesh(device=dev)
    rank = mesh.rank
    data = torch.load(inp)
    alone = mesh.world == 1
    mine = data["batch"] if alone else {k: v[rank : rank + 1] for k, v in data["batch"].items()}
    model = randomize_(ViewFusion(dataclasses.replace(ViewFusionConfig().tiny(), drop_conditions=True),
                                  device="cpu"), seed=0)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    seen = []
    update = trainer._optimizer_update

    def spy(model, state, tc, grads):
        seen.append({n: g.clone() for n, g in grads.items()})
        return update(model, state, tc, grads)

    trainer._optimizer_update = spy

    # 1: one call, one optimizer step
    tc = trainer.TrainConfig(finetune_unet=True)
    state = trainer.init_train_state(model, tc)
    loss = trainer.train_step(model, state, mine, tc, draws=data["draws"] if alone else [data["draws"][rank]])
    res = dict(loss=loss, grads=seen.pop(), masters={n: t.detach().clone() for n, t in state.params.items()})
    if alone:
        torch.save(res, f"{out}{rank}.pt")
        return

    # 2: grad_accum_step 2, reduced once at the optimizer step against reduced every call
    trainer.load_params(model, start)
    tc2 = trainer.TrainConfig(finetune_unet=True, grad_accum_step=2)
    state2 = trainer.init_train_state(model, tc2)
    draws = [[model.loss_draws(3, dev, torch.Generator().manual_seed(100 + 10 * i + rank))] for i in range(2)]
    acc = {n: torch.zeros_like(t) for n, t in state2.opt_state["acc"].items()}
    for i in range(2):
        _, g = trainer.scene_batch_loss(model, mine, draws=draws[i])
        gs = [g[n] if g[n] is not None else torch.zeros_like(a) for n, a in acc.items()]
        parallel.all_reduce_mean_(gs)
        for (n, a), gn in zip(acc.items(), gs):
            a += (gn - a) / (i + 1)
    for i in range(2):
        trainer.train_step(model, state2, mine, tc2, draws=draws[i])
    res.update(at_update=seen.pop(), every_call=acc)
    torch.save(res, f"{out}{rank}.pt")


if __name__ == "__main__":
    main()
