"""The port's learning proof (mvdfusion_tpu_torch/tools/overfit_synthetic.py)
against the JAX tool's pieces (tools/overfit_synthetic.py), at the tiny
config in fp32 on the CPU.

Weights: the port's init_params draws a model, its state dict goes to the
flax layout (the JAX package's mapping and TRANSFORMS) and comes back into a
second port model through convert/from_jax.py; the JAX side runs on that
flax tree.

- pretrain_vae, 3 steps on one scene (16 images a step, the same numpy
  picks on both sides), against the JAX tool's logged losses (5 decimals)
  and its parameters. The first loss, on the same weights, within 1e-5;
  then Adam parts the two: a parameter whose gradient is zero in exact
  arithmetic (an attention key bias, a conv bias ahead of a one-channel
  GroupNorm group) or below Adam's eps moves by +-lr on the sign of
  rounding noise, which differs between the frameworks. So the later
  losses within 1e-3, the reconstruction PSNR within 0.1 dB, every VAE
  parameter within 2 x the sum of the steps' lr (two opposite moves), their
  mean |diff| within 1e-2 of that sum and at most 1% of them past 1e-2 of
  it; the other parameters unchanged.
- evaluate, one scene, 2 DDIM steps of views 3 and 11 on injected init,
  step and jitter noise, against the JAX pieces (prepare_batch, ddim_sample
  with the same noise and the x_clip bound, decode_latents, psnr,
  cross_view_consistency): decoded views and sampled depth within 1e-3 x
  max(1, max|JAX|) (the tolerance of tests/test_torch_port_sampler.py), PSNR
  within 1e-2 dB, depth MAE within 1e-4, the consistency scores within 1e-2.
- the init rules (slow tier: the JAX init alone compiles for ~50 s): the
  zero, one and eye parameters of init_params are the JAX model's init's,
  the others' standard deviations within 15% of its.
- a run of a few steps on the CPU writes report.json with every key of the
  JAX tool's committed report (artifacts/overfit/report.json), the grids,
  the loss curve and the EMA parameters; --quick gives the JAX tool's smoke
  sizes.
- slow tier: also tests/test_learning.py's proof and thresholds, from the
  JAX test's initial weights.
"""

import dataclasses
import json
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu.pipeline.sampler import ddim_sample as j_ddim_sample
from mvdfusion_tpu_torch.convert.from_jax import load_flax_params
from mvdfusion_tpu_torch.tools import overfit_synthetic as O

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import overfit_synthetic as J  # noqa: E402  (the JAX tool)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    base = dict(scenes=1, vae_steps=3, steps=3, eval_ddim_steps=2, seed=0, family="mixed", textured=True,
                log_every=1, device="cpu")
    base.update(kw)
    return O.OverfitArgs(**base)


def _jargs(args):
    fields = {f.name for f in dataclasses.fields(J.OverfitArgs)}
    return J.OverfitArgs(**{k: v for k, v in dataclasses.asdict(args).items() if k in fields})


@pytest.fixture(scope="module")
def pair():
    """A port model from init_params, its flax tree, and a second port model
    loaded from that tree through convert/from_jax.py."""
    args = _args()
    _, batch = O.build_dataset(args)
    src, cfg = O.build_model(args)
    O.init_params(src, args.seed)
    sd = {k: v.detach().numpy() for k, v in src.state_dict().items()}
    tree, flat = {}, {}
    for fp, (tk, tf) in viewfusion_mapping(JConfig().tiny()).items():
        arr = TRANSFORMS[tf](sd[tk]).astype(np.float32)
        flat["/".join(fp)] = arr
        d = tree
        for p in fp[:-1]:
            d = d.setdefault(p, {})
        d[fp[-1]] = jnp.asarray(arr)
    model, _ = O.build_model(args)
    load_flax_params(model, flat)
    assert all(torch.equal(a, b) for a, b in zip(src.state_dict().values(), model.state_dict().values()))
    return dict(args=args, batch=batch, model=model, params={"params": tree}, jm=JViewFusion(JConfig().tiny()))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), max(1.0, np.abs(ref).max())
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol:g} x {scale:.3e}"


def test_pretrain_vae_matches_jax(pair, capfd):
    """Three steps of the VAE pretrain against the JAX tool's (optax: a
    masked chain of clip_by_global_norm(1) and adam on a cosine to 5%)."""
    p = pair
    args = p["args"]
    model = O.build_model(args)[0]
    model.load_state_dict(p["model"].state_dict())
    before = {n: t.clone() for n, t in model.state_dict().items()}
    psnr, losses = O.pretrain_vae(model, p["batch"], args)
    capfd.readouterr()
    jparams, jpsnr = J.pretrain_vae(p["jm"], p["params"], p["batch"], _jargs(args))
    logged = [float(v) for v in re.findall(r"\[vae \d+/3\] recon mse (\S+)", capfd.readouterr().err)]
    assert len(losses) == len(logged) == 3
    assert abs(losses[0] - logged[0]) <= 1e-5, (losses, logged)
    np.testing.assert_allclose(losses[1:], logged[1:], rtol=0, atol=1e-3)
    assert losses[-1] < losses[0]
    assert abs(psnr - jpsnr) <= 0.1, (psnr, jpsnr)
    lr_sum = sum(args.vae_lr * (0.95 * 0.5 * (1 + np.cos(np.pi * i / args.vae_steps)) + 0.05)
                 for i in range(args.vae_steps))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    diffs = []
    for fp, (tk, tf) in viewfusion_mapping(JConfig().tiny()).items():
        if tk.startswith("vae."):
            diffs.append(np.abs(TRANSFORMS[tf](sd[tk]) - np.asarray(_leaf(jparams, fp))).ravel())
        else:
            assert np.array_equal(sd[tk], before[tk].numpy()), tk
    diffs = np.concatenate(diffs) / lr_sum
    assert diffs.max() <= 2.0, diffs.max()
    assert diffs.mean() <= 1e-2, diffs.mean()
    assert (diffs > 1e-2).mean() <= 1e-2, (diffs > 1e-2).mean()
    moved = [n for n in before if n.startswith("vae.") and not torch.equal(before[n], model.state_dict()[n])]
    assert moved


def _leaf(params, fp):
    d = params["params"]
    for k in fp:
        d = d[k]
    return d


def test_evaluate_matches_jax_pieces(pair):
    """One scene's evaluate (views 3 and 11 from view 0, 2 eta=1 steps at CFG
    1, the x_clip rail) on injected noise against prepare_batch, ddim_sample,
    decode_latents, psnr and cross_view_consistency of the JAX package."""
    from mvdfusion_tpu.ops.image import area_downsample as j_area
    from mvdfusion_tpu.utils import metrics as jmetrics
    from mvdfusion_tpu.utils.common import unnormalize as j_unnormalize

    p = pair
    args, batch, jm, params = p["args"], p["batch"], p["jm"], p["params"]
    views = [3, 11]
    B, H, S = len(views), p["model"].cfg.latent_size, args.eval_ddim_steps
    rng = np.random.default_rng(5)
    noise = dict(init_noise=rng.normal(size=(B, H, H, 5)).astype(np.float32),
                 step_noise=rng.normal(size=(S, B, H, H, 5)).astype(np.float32),
                 jitter_noise=rng.normal(size=(S, B, H, H, 1)).astype(np.float32))
    ev, (res,) = O.evaluate(p["model"], batch, args, eval_views=views, tag="port",
                            noise=[{k: torch.as_tensor(v) for k, v in noise.items()}])
    assert list(ev) == views

    s = 0
    j = lambda a: jnp.asarray(np.asarray(a))
    _, cams, in_lat, in_cams, clip_v = jax.jit(
        lambda pp, *a: jm.apply(pp, *a[:7], depths=a[7], method=JViewFusion.prepare_batch)
    )(params, *(j(batch[k][s]) for k in ("images", "R", "T", "f", "c")), j([O.EVAL_INPUT_VIEW]), j(views),
      j(batch["depths"][s]))
    bound = 6.0 * jnp.maximum(1.0, jnp.max(jnp.abs(in_lat)))
    out = j_ddim_sample(params, jm, cams, in_lat, in_cams, clip_v, jax.random.PRNGKey(0), jnp.asarray(1.0),
                        num_steps=S, x_clip=bound, **{k: j(v) for k, v in noise.items()})
    rgb = np.asarray(jax.jit(lambda pp, z: jm.apply(pp, z, method=JViewFusion.decode_latents))(
        params, out.latents[..., :4]))
    depth_pred = np.asarray(j_unnormalize(out.latents[..., 4:5]))
    gt = batch["images"][s][views]
    depth_gt = np.asarray(j_area(j(batch["depths"][s][views]), 4))
    cams_np = tuple(batch[k][s][views] for k in ("R", "T", "f", "c"))
    cons = jmetrics.cross_view_consistency(np.asarray(j_area(j(rgb), 4)), depth_pred, *cams_np)
    cons_gt = jmetrics.cross_view_consistency(np.asarray(j_area(j(gt), 4)), depth_gt, *cams_np)

    _close(res["rgb"], rgb, 1e-3, "decoded views")
    _close(res["depth_pred"], depth_pred, 1e-3, "sampled depth")
    np.testing.assert_array_equal(res["gt"], gt)
    np.testing.assert_allclose(res["depth_gt"], depth_gt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["psnr"], [jmetrics.psnr(rgb[i], gt[i]) for i in range(B)], rtol=0, atol=1e-2)
    assert abs(res["depth_mae"] - float(np.mean(np.abs(depth_pred - depth_gt)))) <= 1e-4
    for k in ("photo_mae", "depth_agree_rate", "covis_frac"):
        assert abs(res["consistency"][k] - cons[k]) <= 1e-2, (k, res["consistency"][k], cons[k])
        assert abs(res["consistency_gt"][k] - cons_gt[k]) <= 1e-6, k


@pytest.mark.slow
def test_init_params_follow_the_jax_init():
    """init_params against the JAX model's own init at the tiny config (the
    JAX tool's init_params): the same parameters all zero, all one and eye;
    every other tensor of more than 200 entries with its standard deviation
    within 15% of the JAX one's (independent draws of one distribution)."""
    p_args = _args()
    _, batch = O.build_dataset(p_args)
    jparams = J.init_params(JViewFusion(JConfig().tiny()), batch, 0)
    model, _ = O.build_model(p_args)
    O.init_params(model, 0)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    checked = 0
    for fp, (tk, tf) in viewfusion_mapping(JConfig().tiny()).items():
        ours, ref = TRANSFORMS[tf](sd[tk]), np.asarray(_leaf(jparams, fp))
        assert ours.shape == ref.shape, tk
        for name, pred in (("zero", lambda a: not a.any()), ("one", lambda a: (a == 1).all())):
            assert pred(ours) == pred(ref), f"{tk}: {name} in one package only"
        if fp[0] == "cc_layers_0" and fp[-1] == "kernel":
            np.testing.assert_array_equal(ours, ref)  # eye over zeros
        elif ref.any() and not (ref == 1).all() and ref.size > 200:
            assert 0.85 < ours.std() / ref.std() < 1.15, (tk, ours.std(), ref.std())
            checked += 1
    assert checked > 100


def test_run_writes_the_jax_report(tmp_path):
    """A run of a few steps on the CPU: report.json holds every key of the
    JAX tool's committed report with the same structure, the grids, the loss
    curve and the EMA parameters are written, and --eval-only samples them
    again to the same trained PSNR."""
    args = _args(scenes=1, vae_steps=2, steps=3, eval_ddim_steps=2, out=str(tmp_path))
    report = O.run(args)
    jax_report = json.loads((REPO / "artifacts" / "overfit" / "report.json").read_text())
    assert set(jax_report) <= set(report), set(jax_report) - set(report)
    for k, v in jax_report.items():
        assert type(report[k]) is type(v) or isinstance(report[k], float) and isinstance(v, float), k
        if isinstance(v, dict):
            assert set(report[k]) == set(v), k
    assert report["steps"] == 3 and report["eval_views"] == [3, 11, 5, 13] and report["heldout_views"] == [3, 11]
    assert json.loads((tmp_path / "report.json").read_text()) == json.loads(json.dumps(report))
    curve = np.load(tmp_path / "loss_curve.npy")
    assert curve.shape == (3,)
    ref = np.load(REPO / "artifacts" / "overfit" / "loss_curve.npy")
    assert O.loss_windows(curve, ref, every=1, width=2) == [
        (i, float(np.mean(curve[i:i + 2])), float(np.mean(ref[i:i + 2]))) for i in (0, 1)]
    for tag in ("floor", "trained", "ablated"):
        assert (tmp_path / f"{tag}_grid.png").stat().st_size > 0
    saved = torch.load(tmp_path / O.PARAMS_FILE)
    assert set(saved) == {n for n, _ in O.build_model(args)[0].named_parameters()}
    again = O.run(args, eval_only=True)
    assert abs(again["trained_psnr"] - report["trained_psnr"]) <= 1e-9


def test_main_quick_takes_the_jax_tools_smoke_sizes(monkeypatch):
    """--quick: 2 scenes, 60 VAE steps, 150 diffusion steps, 8 DDIM steps,
    a log line every 20, as the JAX tool's; --device reaches the run."""
    seen = []
    monkeypatch.setattr(O, "run", lambda args, eval_only=False: seen.append((args, eval_only)))
    O.main(["--quick", "--device", "cpu", "--model", "medium", "--family", "mixed", "--textured"])
    (args, eval_only), = seen
    assert (args.scenes, args.vae_steps, args.steps, args.eval_ddim_steps, args.log_every) == (2, 60, 150, 8, 20)
    assert (args.device, args.model, args.family, args.textured, eval_only) == ("cpu", "medium", "mixed", True, False)
    assert O.model_config("medium").unet_model_channels == 96


@pytest.mark.slow
def test_overfit_learns():
    """tests/test_learning.py::test_overfit_learns on the port: the same
    experiment (tiny, 2 scenes of the mixed family with textures, 120 VAE
    steps, 260 diffusion steps, 8 DDIM steps on views 3 and 11) from the JAX
    test's own initial weights (the JAX model's init, carried across by
    convert/from_jax.py), with that test's four thresholds. The port's own
    init draw runs on the card (chip_smoke.py --learn): the untrained UNet
    predicts exactly zero noise (its output conv starts at zero), so the
    floor is the pretrained VAE decoding noise and moves with the VAE's
    init draw by more than the threshold's 1.5 dB margin."""
    torch.set_num_threads(max(2, os.cpu_count() or 2))
    args = O.OverfitArgs(scenes=2, vae_steps=120, steps=260, eval_ddim_steps=8, lr=1e-3, vae_lr=3e-3, seed=0,
                         log_every=50, family="mixed", textured=True, device="cpu")
    _, batch = O.build_dataset(args)
    jparams = J.init_params(JViewFusion(JConfig().tiny()), batch, args.seed)
    flat = {"/".join(fp): np.asarray(_leaf(jparams, fp)) for fp in viewfusion_mapping(JConfig().tiny())}
    model, _ = O.build_model(args)
    load_flax_params(model, flat)

    vae_psnr, _ = O.pretrain_vae(model, batch, args)
    assert vae_psnr > 14.0, f"VAE failed to learn: {vae_psnr:.2f} dB"
    _, floor = O.evaluate(model, batch, args, eval_views=[3, 11], tag="floor")
    floor_psnr = float(np.mean([p for r in floor for p in r["psnr"]]))
    floor_dmae = float(np.mean([r["depth_mae"] for r in floor]))
    _, losses, _ = O.train_diffusion(model, batch, args)
    first, last = float(np.mean(losses[:40])), float(np.mean(losses[-40:]))
    assert last < 0.62 * first, f"no loss progress: {first:.4f} -> {last:.4f}"
    _, trained = O.evaluate(model, batch, args, eval_views=[3, 11], tag="trained")
    trained_psnr = float(np.mean([p for r in trained for p in r["psnr"]]))
    trained_dmae = float(np.mean([r["depth_mae"] for r in trained]))
    assert trained_psnr > floor_psnr + 1.5, f"novel-view PSNR did not improve: {floor_psnr:.2f} -> {trained_psnr:.2f}"
    assert trained_dmae < floor_dmae, f"depth MAE did not improve: {floor_dmae:.4f} -> {trained_dmae:.4f}"
