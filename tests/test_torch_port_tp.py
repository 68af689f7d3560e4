"""The port's tensor parallelism (parallel/mesh.py, parallel/tensor.py and
their users) on the CPU at the tiny config in fp32, two ranks as OS
processes over gloo (tests/torch_port_tp_worker.py) against one rank, and
the one rank against the JAX package:

(a) tp = 2 against tp = 1: 2 DDIM steps (atol 5e-4), scene_batch_loss on 2
    scenes (5e-4 relative), gather_params giving the whole model back (and
    a loader's whole tensors landing as each rank's slices), one
    train_step: the clip's global norm (1e-5 relative), the gradient the
    optimizer reads, gathered (1e-5 x max|g|), the whole parameters'
    gradients bit-equal on both tp ranks, and the masters after the step
    within the gap their two gradients explain through AdamW's first step.
    The tp = 1 port against the JAX package: the same 2 DDIM steps and the
    loss on the JAX side's draws, at test_eval_batched.py's tolerances.
(b) One bf16 row-parallel Linear against the whole one within 1 bf16 ulp
    (the fp32 partial products reassociate; a doubled bias does not fit).
(c) A C = 1280 SpatialTransformer (8 heads; the tiny config keeps every
    site whole) at tp = 2 against the whole site, fp32, 1e-5 x max: its
    module path on 4 local heads a rank, and its big-C form
    (MVDF_BLOCK_BIGC=1: K6's plain version on the CPU) on the weights
    gathered whole.

The ranks are launched as tests/test_torch_port_parallel.py launches its.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.pipeline.sampler as jsampler
import mvdfusion_tpu.pipeline.trainer as jtrainer
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.geometry.cameras import Cameras as JCameras
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.pipeline import trainer
from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_port_tp_common import (  # noqa: E402
    GRAD_CLIP, _few_threads, _one_rank, _tiny, adam_gap, close, inputs, run_workers,
)

@pytest.fixture(scope="module")
def tp2(inputs, tmp_path_factory):
    """2 ranks at tp = 2 (the worker), and one rank without a mesh."""
    ranks = run_workers(inputs, tmp_path_factory.mktemp("tp2") / "out", 1, 1, 2)
    data = inputs["data"]
    model = _tiny()
    s = data["sample"]
    with torch.no_grad():
        latents = ddim_sample(model, Cameras(*s["cams"]), s["in_lat"], Cameras(*s["in_cams"]), s["clip_v"], 2.5,
                              num_steps=2, init_noise=s["init"], step_noise=s["step_noise"],
                              jitter_noise=s["jitter"]).latents
    batch_loss = trainer.scene_batch_loss(model, data["batch"], draws=data["draws"])[0].detach()
    one = _one_rank(data, trainer.TrainConfig(finetune_unet=True, grad_clip=GRAD_CLIP))
    return dict(ranks=ranks, latents=latents, batch_loss=batch_loss, params=dict(model.named_parameters()), **one)


def test_tp2_samples_and_loss_match_tp1(tp2):
    for res in tp2["ranks"]:
        assert res["split"], "nothing split at tp = 2"
        np.testing.assert_allclose(res["latents"].numpy(), tp2["latents"].numpy(), atol=5e-4)
        assert abs(float(res["batch_loss"]) - float(tp2["batch_loss"])) <= 5e-4 * abs(float(tp2["batch_loss"]))
        for n, p in tp2["params"].items():  # gather_params: the whole model back
            assert torch.equal(res["whole_params"][n], p.detach()), n
        assert res["loaded"]  # the loader wrote each rank's slices of the whole tensors
    a, b = (r["latents"] for r in tp2["ranks"])
    assert torch.equal(a, b)  # the tp ranks end with the same latents


def test_tp2_train_step_matches_tp1(tp2):
    lr = trainer.TrainConfig().lr
    scale = min(1.0, GRAD_CLIP / float(tp2["norm"]))
    assert scale < 1  # the clip acted
    top = max(float(g.abs().max()) for g in tp2["grads"].values())
    r0, r1 = tp2["ranks"]
    for res in (r0, r1):
        close(res["loss"], tp2["loss"], 2e-5, "loss")
        close(res["norm"], tp2["norm"], 1e-5, "clip norm")
        assert res["grads"].keys() == tp2["grads"].keys()
        for n, g in tp2["grads"].items():
            err = float((res["grads"][n] - g).abs().max())
            assert err <= 1e-5 * top, (n, err, top)
            ratio = adam_gap(res["masters"][n], tp2["masters"][n], res["grads"][n] * scale, g * scale, lr)
            assert ratio <= 1, (n, ratio)
    # whole parameters: the same gradient on both tp ranks (the CPU's sums are deterministic), before the
    # trainer's mean over tp that keeps them so where a backward kernel adds with atomics
    assert len(r0["whole_grads"]) > 100 and r0["whole_grads"].keys() == r1["whole_grads"].keys()
    for n, g in r0["whole_grads"].items():
        assert torch.equal(g, r1["whole_grads"][n]), n
    for n in r0["local"]:
        if n not in r0["split"]:
            assert torch.equal(r0["local"][n], r1["local"][n]), n
    assert torch.equal(r0["masters"][r0["split"][0]], r1["masters"][r0["split"][0]])


def test_row_parallel_bf16_linear_within_one_ulp(tp2):
    for res in tp2["ranks"]:
        r = res["row_linear"]
        want, got = r["want"].float(), r["got"].float()
        ulp = lambda t: torch.nextafter(t.abs().to(torch.bfloat16), torch.tensor(float("inf"), dtype=torch.bfloat16)
                                        ).float() - t.abs()
        assert got.dtype == want.dtype
        assert bool(((got - want).abs() <= ulp(want)).all())
        doubled = (r["got"] + r["bias"]).float()  # a bias each rank added: far outside
        assert not bool(((doubled - want).abs() <= ulp(want)).all())


@pytest.mark.parametrize("shape", [(6, 24), (2, 5, 40)])
def test_row_partial_product_matches_fp32_autograd(shape):
    """A bf16 row layer's partial product (nn/layers.py::_PartialProduct)
    and its backward against autograd through the fp32 upcasts: the same
    fp32 product, and the same gradients rounded to bf16 once."""
    from mvdfusion_tpu_torch.nn.layers import _PartialProduct

    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(*shape, generator=g).bfloat16().requires_grad_()
    w = torch.randn(16, shape[-1], generator=g).bfloat16().requires_grad_()
    cot = torch.randn(*shape[:-1], 16, generator=g).bfloat16().float()  # the cotangent of a bf16 rounding
    ref = torch.nn.functional.linear(x.float(), w.float())
    ref_gx, ref_gw = torch.autograd.grad(ref, (x, w), cot)
    got = _PartialProduct.apply(x, w)
    gx, gw = torch.autograd.grad(got, (x, w), cot)
    assert got.dtype == torch.float32 and torch.allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert gx.dtype == gw.dtype == torch.bfloat16
    for a, b in ((gx, ref_gx), (gw, ref_gw)):
        ulp = torch.finfo(torch.bfloat16).eps * b.float().abs()
        assert bool(((a.float() - b.float()).abs() <= ulp).all())


@pytest.fixture(scope="module")
def jax_pair(inputs):
    model = _tiny()
    jcfg = dataclasses.replace(JConfig().tiny(), drop_conditions=True, fuse_mode="never")
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = {}
    for fp, (tk, tf) in viewfusion_mapping(jcfg).items():
        d = tree
        for p in fp[:-1]:
            d = d.setdefault(p, {})
        d[fp[-1]] = jnp.asarray(TRANSFORMS[tf](sd[tk]).astype(np.float32))
    return JViewFusion(jcfg), {"params": tree}


def test_tp1_matches_jax(inputs, tp2, jax_pair):
    """The tp = 1 side of (a) against the JAX package: the 2 DDIM steps on
    the same noise and the loss on the JAX side's draws, at the
    tolerances of test_eval_batched.py's tp witness (atol 5e-4; 5e-4
    relative)."""
    jm, params = jax_pair
    s = inputs["np_sample"]
    jc = lambda a: JCameras(*(jnp.asarray(x, jnp.float32) for x in a))
    ref = jsampler.ddim_sample(params, jm, jc(s["cams"]), jnp.asarray(s["in_lat"]), jc(s["in_cams"]),
                               jnp.asarray(s["clip_v"]), jax.random.PRNGKey(0), jnp.asarray(2.5), num_steps=2,
                               init_noise=jnp.asarray(s["init"]), step_noise=jnp.asarray(s["step_noise"]),
                               jitter_noise=jnp.asarray(s["jitter"]))
    np.testing.assert_allclose(tp2["latents"].numpy(), np.asarray(ref.latents), atol=5e-4)
    jb = {k: jnp.asarray(v) for k, v in inputs["np_batch"].items()}
    l_ref = float(jax.jit(lambda p: jtrainer.scene_batch_loss(jm, p, jb, inputs["key"]))(params))
    assert abs(float(tp2["batch_loss"]) - l_ref) <= 5e-4 * max(1.0, abs(l_ref)), (float(tp2["batch_loss"]), l_ref)


def test_c1280_site_split_matches_whole(tp2):
    for res in tp2["ranks"]:
        r = res["site"]
        assert r["n_split"] >= 8
        for got, want, what in zip(r["split"], r["whole"], ("module path", "big-C form")):
            close(got, want, 1e-5, what)
