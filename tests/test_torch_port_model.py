"""The port's whole model at the tiny config against the JAX package.

One random state dict (seeded, non-symmetric, no zero-inits) feeds both: the
port uses it directly and the JAX ViewFusion gets it as flax params through
convert/mapping.py's tables and TRANSFORMS. The JAX side runs its Pallas
kernels in interpret mode (fuse_mode="interpret"). Inputs and noise are numpy
arrays from a seed, fp32 on the CPU.

Tolerance: max|diff| <= 1e-3 x max|JAX output| for the full model, the
sampler trajectory and the image path (fp32 through ~60 layers, sums in a
different order; a layout or transpose fault shows as O(1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.geometry.cameras import Cameras as JCameras
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu.pipeline.sampler import ddim_sample as j_ddim_sample
from mvdfusion_tpu_torch.convert.from_jax import load_flax_params, viewfusion_table
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

REL = 1e-3
S, IMG = 4, 64  # scene views; 64^2 images -> 16^2 latents with the tiny VAE


def rel_close(got, ref, tol=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1e-6), f"max|diff| {err:.3e} vs max|ref| {scale:.3e}"


def flat_flax(model, jcfg):
    """The port's state dict as flat {"path/to/leaf": array} flax params."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return {"/".join(fp): TRANSFORMS[tf](sd[tk]).astype(np.float32)
            for fp, (tk, tf) in viewfusion_mapping(jcfg).items()}


def nest(flat):
    tree = {}
    for path, leaf in flat.items():
        d = tree
        *head, last = path.split("/")
        for p in head:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(leaf)
    return {"params": tree}


@pytest.fixture(scope="module")
def pair():
    cfg = ViewFusionConfig().tiny()
    jcfg = dataclasses.replace(JConfig().tiny(), fuse_mode="interpret")
    model = randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()
    jm = JViewFusion(jcfg)
    rng = np.random.default_rng(0)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    scene = dict(
        images=rng.uniform(size=(S, IMG, IMG, 3)).astype(np.float32),
        R=R, T=T, f=np.full((S, 2), 2.1875, np.float32), c=np.zeros((S, 2), np.float32),
        input_idx=np.array([0]), target_idx=np.array([1, 2, 3]),
    )
    apply_cfg = jax.jit(lambda p, *a: jm.apply(p, *a, method=JViewFusion.apply_model_cfg))
    return dict(cfg=cfg, jcfg=jcfg, model=model, jm=jm, flat=flat_flax(model, jcfg), scene=scene,
                rng=rng, apply_cfg=apply_cfg)


def _step_inputs(p):
    rng = np.random.default_rng(1)
    B, H = 3, p["cfg"].latent_size
    R, T, f, c = (p["scene"][k] for k in ("R", "T", "f", "c"))
    return dict(
        noisy=rng.normal(size=(B, H, H, 5)).astype(np.float32),
        in_lat=rng.normal(size=(1, H, H, 5)).astype(np.float32),
        clip_v=rng.normal(size=(B, 1, p["cfg"].context_dim + 28)).astype(np.float32),
        jitter=rng.normal(size=(B, H, H, 1)).astype(np.float32),
        t=np.full((B,), 500, np.int32),
        cams=(R[1:], T[1:], f[1:], c[1:]), in_cams=(R[:1], T[:1], f[:1], c[:1]),
    )


def _jcams(a):
    return JCameras(*(jnp.asarray(x, jnp.float32) for x in a))


def _tcams(a):
    return Cameras(*(torch.as_tensor(np.asarray(x, np.float32)) for x in a))


def _run_both(p, model, flat):
    i = _step_inputs(p)
    ref = p["apply_cfg"](nest(flat), jnp.asarray(i["noisy"]), _jcams(i["cams"]), jnp.asarray(i["in_lat"]),
                         _jcams(i["in_cams"]), jnp.asarray(i["clip_v"]), jnp.asarray(i["t"]),
                         jax.random.PRNGKey(0), jnp.asarray(2.5), None, jnp.asarray(i["jitter"]))
    with torch.no_grad():
        out = model.apply_model_cfg(torch.tensor(i["noisy"]), _tcams(i["cams"]), torch.tensor(i["in_lat"]),
                                    _tcams(i["in_cams"]), torch.tensor(i["clip_v"]), torch.tensor(i["t"]).long(),
                                    2.5, torch.tensor(i["jitter"]))
    return out, ref


def test_state_dict_keys_match_reference_mapping(pair):
    keys = set(pair["model"].state_dict())
    assert keys == {tk for tk, _ in viewfusion_mapping(pair["jcfg"]).values()}
    assert keys == set(viewfusion_table(pair["cfg"]))


def test_apply_model_cfg_matches(pair):
    out, ref = _run_both(pair, pair["model"], pair["flat"])
    rel_close(out, ref)


def test_ddim_trajectory_matches_shared_noise(pair):
    """Four eta=1 DDIM steps at CFG 2.5 with init, step and jitter noise shared."""
    p, steps = pair, 4
    i = _step_inputs(p)
    rng = np.random.default_rng(2)
    B, H = 3, p["cfg"].latent_size
    init = rng.normal(size=(B, H, H, 5)).astype(np.float32)
    step_noise = rng.normal(size=(steps, B, H, H, 5)).astype(np.float32)
    jitter = rng.normal(size=(steps, B, H, H, 1)).astype(np.float32)
    ref = j_ddim_sample(nest(p["flat"]), p["jm"], _jcams(i["cams"]), jnp.asarray(i["in_lat"]),
                        _jcams(i["in_cams"]), jnp.asarray(i["clip_v"]), jax.random.PRNGKey(0), jnp.asarray(2.5),
                        num_steps=steps, return_trajectory=True, init_noise=jnp.asarray(init),
                        step_noise=jnp.asarray(step_noise), jitter_noise=jnp.asarray(jitter))
    res = ddim_sample(p["model"], _tcams(i["cams"]), torch.tensor(i["in_lat"]), _tcams(i["in_cams"]),
                      torch.tensor(i["clip_v"]), 2.5, num_steps=steps, return_trajectory=True,
                      init_noise=torch.tensor(init), step_noise=torch.tensor(step_noise),
                      jitter_noise=torch.tensor(jitter))
    rel_close(res.pred_x0_trajectory, ref.pred_x0_trajectory)
    rel_close(res.latents, ref.latents)


def test_prepare_batch_and_decode_match(pair):
    """Image in, image out: VAE encode + depth + relative cameras + CLIP and
    pose embedding, then the VAE decode of the target latents."""
    p = pair
    sc = p["scene"]
    params = nest(p["flat"])
    args = [jnp.asarray(sc[k]) for k in ("images", "R", "T", "f", "c", "input_idx", "target_idx")]
    ref = jax.jit(lambda q, *a: p["jm"].apply(q, *a, method=JViewFusion.prepare_batch))(params, *args)
    with torch.no_grad():
        out = p["model"].prepare_batch(*(torch.as_tensor(np.asarray(sc[k])) for k in
                                         ("images", "R", "T", "f", "c", "input_idx", "target_idx")))
    for o, r in zip(out, ref):
        if isinstance(o, Cameras):
            for a, b in zip(o, r):
                rel_close(a, b)
        else:
            rel_close(o, r)
    z = np.asarray(ref[0])[..., :4]
    img_ref = jax.jit(lambda q, a: p["jm"].apply(q, a, method=JViewFusion.decode_latents))(params, jnp.asarray(z))
    with torch.no_grad():
        img = p["model"].decode_latents(torch.tensor(z))
    assert tuple(img.shape) == (3, IMG, IMG, 3)
    rel_close(img, img_ref)


def test_load_flax_params(pair):
    """(1) JAX-layout params made from the port's state dict by the JAX
    package's TRANSFORMS load back into a fresh port model bit-exactly;
    (2) after perturbing every leaf (so square matrices such as the 64x64
    cc_projection layers and CLIP projections are not symmetric in any
    sense), the loaded port model and JAX agree on apply_model_cfg."""
    p = pair
    fresh = ViewFusion(p["cfg"], device="cpu").eval()
    load_flax_params(fresh, {"params/" + k: v for k, v in p["flat"].items()})
    sd, ref_sd = fresh.state_dict(), p["model"].state_dict()
    assert all(torch.equal(sd[k], ref_sd[k]) for k in ref_sd)
    rng = np.random.default_rng(5)
    flat2 = {k: v + (0.02 * rng.normal(size=v.shape)).astype(np.float32) for k, v in p["flat"].items()}
    load_flax_params(fresh, flat2)
    out, ref = _run_both(p, fresh, flat2)
    rel_close(out, ref)


def test_chip_smoke_slice_rehearsal_on_cpu():
    """chip_smoke.py's slice phase at the tiny config on the CPU: the same
    control flow and checks as on the card, minus the launch counts."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.run_slice(2, "cpu", device="cpu", cfg=ViewFusionConfig().tiny()) == {}
