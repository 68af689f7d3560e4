"""One rank of tests/test_torch_port_tp.py's tensor- and view-parallel runs
(started with torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).

    python tests/torch_port_tp_worker.py DP SP TP IN.pt OUT_PREFIX

IN.pt holds the tiny config's inputs: a 2-scene batch with each scene's
p_losses draws, and a sampling request with its noise. Every rank builds the
tiny model (fp32, drop_conditions, randomize_ seed 0), splits it on the
(DP, SP, TP) mesh (parallel.shard_params_) and:
  * with SP 1: 2 DDIM steps of the request (CFG 2.5), scene_batch_loss on
    both scenes, the whole parameters loaded into a split model of other
    weights (convert/reference.py::load_state), one train_step (every UNet leaf trainable, a global-norm
    clip low enough to act) recording the clip's norm, the gradient the
    optimizer reads and the whole masters after it (state_payload), one
    bf16 row-parallel Linear against the whole layer, and a C = 1280 site
    (module path and big-C form) against the whole site;
  * else: one train_step on the dp rank's scenes (grad_accum_step 1),
    recording the loss and the whole gradient the optimizer reads.
Writes OUT_PREFIX{rank}.pt.
"""

import dataclasses
import sys


def main() -> None:
    dp, sp, tp = (int(a) for a in sys.argv[1:4])
    inp, out = sys.argv[4], sys.argv[5]

    import torch

    from mvdfusion_tpu_torch import parallel
    from mvdfusion_tpu_torch.geometry.cameras import Cameras
    from mvdfusion_tpu_torch.nn.layers import Linear, dense
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
    from mvdfusion_tpu_torch.parallel.mesh import gather_tensor
    from mvdfusion_tpu_torch.parallel.tensor import split_of
    from mvdfusion_tpu_torch.pipeline import trainer
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

    dev = parallel.init_distributed("cpu")
    mesh = parallel.make_mesh(dp=dp, tp=tp, sp=sp, device=dev)
    d = mesh.coords[0]
    data = torch.load(inp)

    def build():
        model = randomize_(ViewFusion(dataclasses.replace(ViewFusionConfig().tiny(), drop_conditions=True),
                                      device="cpu"), seed=0)
        return parallel.shard_params_(model, mesh)

    seen = []
    update = trainer._optimizer_update

    def spy(model, state, tc, grads):
        names = list(grads)
        norm = trainer.global_norm(model, state, names, [grads[n] for n in names])
        seen.append(dict(norm=norm, local={n: g.clone() for n, g in grads.items()},
                         grads={n: gather_tensor(g, state.splits.get(n)).clone() for n, g in grads.items()}))
        return update(model, state, tc, grads)

    trainer._optimizer_update = spy
    res = dict(coords=mesh.coords)
    per = len(data["draws"]) // dp
    mine = {k: v[d * per : (d + 1) * per] for k, v in data["batch"].items()}
    draws = data["draws"][d * per : (d + 1) * per]
    model = build()
    if sp == 1:
        s = data["sample"]
        cams = lambda a: Cameras(*a)
        with torch.no_grad():
            res["latents"] = ddim_sample(model, cams(s["cams"]), s["in_lat"], cams(s["in_cams"]), s["clip_v"], 2.5,
                                         num_steps=2, init_noise=s["init"], step_noise=s["step_noise"],
                                         jitter_noise=s["jitter"]).latents
        batch_loss, grads = trainer.scene_batch_loss(model, mine, draws=draws)
        res["batch_loss"] = batch_loss.detach()
        res["whole_grads"] = {n: g for n, g in grads.items() if g is not None and split_of(model.get_parameter(n)) is None}
        res["whole_params"] = {n: t.clone() for n, t in parallel.gather_params(model, mesh).items()}
        # the reference's loader into a split model of other weights: each rank takes its slices
        from mvdfusion_tpu_torch.convert.reference import load_state

        other = parallel.shard_params_(randomize_(ViewFusion(model.cfg, device="cpu"), seed=4), mesh)
        load_state(other, res["whole_params"], verbose=False)
        res["loaded"] = all(torch.equal(t, res["whole_params"][n])
                            for n, t in parallel.gather_params(other, mesh).items())
        del other
        tc = trainer.TrainConfig(finetune_unet=True, grad_clip=data["grad_clip"])
    else:
        tc = trainer.TrainConfig(finetune_unet=True)
    state = trainer.init_train_state(model, tc)
    res["loss"] = trainer.train_step(model, state, mine, tc, draws=draws)
    res.update(seen.pop())
    res["masters"] = trainer.state_payload(state, 0)["params"]
    res["split"] = sorted(state.splits)

    if sp == 1 and tp > 1:
        # the rounding point: a row-parallel bf16 Linear against the whole one
        g = torch.Generator().manual_seed(5)
        lin = Linear(256, 64).to(torch.bfloat16)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(64, 256, generator=g) / 16)
            lin.bias.copy_(torch.randn(64, generator=g))
        x = torch.randn(8, 256, generator=g).to(torch.bfloat16)
        want = dense(x, lin.weight, lin.bias)
        axis = mesh.axes["tp"]
        from mvdfusion_tpu_torch.parallel.tensor import Split, shard

        split = Split(1, 1, axis)
        lin.weight.data = shard(lin.weight.data, split)
        lin.weight._mvdf_split = split
        assert split_of(lin.weight) is split
        res["row_linear"] = dict(got=lin(x).detach(), want=want.detach(), bias=lin.bias.detach())

        # a C = 1280 site (8 heads): its module path on local heads, and the
        # big-C form (MVDF_BLOCK_BIGC=1, K6's plain version on the CPU) on its
        # gathered weights, each against the whole site
        import os

        from mvdfusion_tpu_torch.nn.unet import SpatialTransformer

        site = randomize_(SpatialTransformer(1280, 8, 160, 1, 768), seed=9)
        g = torch.Generator().manual_seed(6)
        x, ctx = torch.randn(2, 8, 8, 1280, generator=g), torch.randn(2, 1, 768, generator=g)

        def both():
            with torch.no_grad():
                never = site(x, ctx, "never")
                os.environ["MVDF_BLOCK_BIGC"] = "1"
                try:
                    big = site(x, ctx, "auto")
                finally:
                    os.environ.pop("MVDF_BLOCK_BIGC")
            return never, big

        whole = both()
        parallel.shard_params_(site, mesh)
        res["site"] = dict(whole=whole, split=both(), n_split=sum(split_of(p) is not None for p in site.parameters()))
    torch.save(res, f"{out}{mesh.rank}.pt")


if __name__ == "__main__":
    main()
