"""The port's training forward against the JAX package at the tiny config,
fp32 on the CPU: GridAttn's general path (V = 3, V = 18 past K4's gate, and
the top-k view window), q_sample and predict_start_from_noise, apply_model
with each condition-dropout band, and p_losses for both objectives and with
feed_prev_depth, on the JAX side's own random draws.

One random state dict feeds both sides (through convert/mapping.py's tables
and TRANSFORMS, as in test_torch_port_model.py). Tolerance: max|diff| <=
1e-4 x max(1, max|JAX|) for every forward (fp32 sums in another order; a
layout or rounding-point fault shows as O(1e-2) or more).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.core import schedule as jsched
from mvdfusion_tpu.geometry.cameras import Cameras as JCameras
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu_torch.core import schedule as tsched
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_

TOL = 1e-4
S, IMG = 6, 64  # 1 input + 5 targets; 64^2 images -> 16^2 latents



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs (restored after): beside
    the suite's other workers, more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)

def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), max(1.0, np.abs(ref).max())
    assert err <= tol * scale, f"max|diff| {err:.3e} vs tolerance {tol * scale:.3e}"


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
    cfg = dataclasses.replace(ViewFusionConfig().tiny(), drop_conditions=True)
    jcfg = dataclasses.replace(JConfig().tiny(), drop_conditions=True, fuse_mode="never")
    model = randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    flat = {"/".join(fp): TRANSFORMS[tf](sd[tk]).astype(np.float32) for fp, (tk, tf) in viewfusion_mapping(jcfg).items()}
    rng = np.random.default_rng(0)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    scene = dict(images=rng.uniform(size=(S, IMG, IMG, 3)).astype(np.float32), R=np.asarray(R, np.float32),
                 T=np.asarray(T, np.float32), f=np.full((S, 2), 2.1875, np.float32), c=np.zeros((S, 2), np.float32),
                 input_idx=np.array([0]), target_idx=np.arange(1, S))
    return dict(cfg=cfg, jcfg=jcfg, model=model, params=nest(flat), scene=scene)


def _tscene(sc):
    return [torch.as_tensor(sc[k]) for k in ("images", "R", "T", "f", "c", "input_idx", "target_idx")]


def _jscene(sc):
    return [jnp.asarray(sc[k]) for k in ("images", "R", "T", "f", "c", "input_idx", "target_idx")]


# ------------------------------------------------------------ GridAttn
def _rig(V):
    R, T = look_at_view_transform(dist=1.5, elev=25.0, azim=np.linspace(0, 360, V + 1, endpoint=False) + 90)
    R, T = np.asarray(R, np.float32), np.asarray(T, np.float32)
    f, c = np.full((V + 1, 2), 2.1875, np.float32), np.zeros((V + 1, 2), np.float32)
    return [(R[s], T[s], f[s], c[s]) for s in (slice(1, None), slice(0, 1))]


def _view_attn_both(p, V, top_k: bool, fuse_mode: str):
    cfg = p["cfg"]
    H, D, E = cfg.latent_size, cfg.n_pts_per_ray, cfg.time_embed_dim
    rng = np.random.default_rng(V)
    noisy = rng.normal(size=(V, H, H, 5)).astype(np.float32)
    in_lat = rng.normal(size=(1, H, H, 5)).astype(np.float32)
    temb = rng.normal(size=(V, E)).astype(np.float32)
    jitter = rng.normal(size=(V, H, H, D)).astype(np.float32)
    t = np.full((V,), 400, np.int32)
    cams, in_cams = _rig(V)
    jcfg = dataclasses.replace(p["jcfg"], keep_top_k_views=top_k, top_k=4)
    jm = JViewFusion(jcfg)

    def run(mdl, params, *a):
        return mdl.apply(params, *a, method=lambda m, x, cm, tm, tt, il, ic, jn: m.view_attn(
            x, cm, jnp.ones((x.shape[0],)), tm, tt, m.sched, il, ic, jax.random.PRNGKey(0), jitter_noise=jn))

    ref = jax.jit(lambda params, *a: run(jm, params, *a))(
        p["params"], jnp.asarray(noisy), JCameras(*map(jnp.asarray, cams)), jnp.asarray(temb), jnp.asarray(t),
        jnp.asarray(in_lat), JCameras(*map(jnp.asarray, in_cams)), jnp.asarray(jitter))
    va = p["model"].view_attn
    va.keep_top_k_views, va.top_k = top_k, 4
    try:
        with torch.no_grad():
            out = va(torch.tensor(noisy), Cameras(*map(torch.tensor, cams)), torch.ones(V), torch.tensor(temb),
                     torch.tensor(t).long(), p["model"].sched("cpu"), torch.tensor(in_lat),
                     Cameras(*map(torch.tensor, in_cams)), torch.tensor(jitter), fuse_mode=fuse_mode)
    finally:
        va.keep_top_k_views = False
    return out, ref


@pytest.mark.parametrize("V,top_k,fuse_mode", [(3, False, "never"), (18, False, "auto"), (8, True, "auto")],
                         ids=["V3-never", "V18-past-gate", "V8-top-k"])
def test_gridattn_general_path_matches(pair, V, top_k, fuse_mode):
    """GridAttn's general path: V = 3 under fuse_mode "never", V = 18 past
    K4's gate (fuse_mode "auto" takes it by itself), the top-k window of 5
    views at V = 8 (wrapping at both ends)."""
    out, ref = _view_attn_both(pair, V, top_k, fuse_mode)
    assert out.shape == (V, 16, 16, 1, pair["cfg"].context_dim)
    close(out, ref)


def test_gridattn_general_path_equals_kernel_plain_in_fp32(pair):
    """At V = 3 in fp32 the general path and K4's plain version (fuse_mode
    "auto" on the CPU) compute one function: 1e-4 x max(1, max|ref|)."""
    out_never, _ = _view_attn_both(pair, 3, False, "never")
    out_auto, _ = _view_attn_both(pair, 3, False, "auto")
    close(out_auto, out_never.numpy())


# ------------------------------------------------------------ schedule
def test_q_sample_and_predict_start_match():
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(4, 8, 8, 5)).astype(np.float32)
    eps = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 17, 500, 999])
    js, ts = jsched.make_ddpm_schedule(1000), tsched.make_ddpm_schedule(1000)
    xt = tsched.q_sample(ts, torch.tensor(x0), torch.tensor(t), torch.tensor(eps))
    close(xt, jsched.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps)))
    back = tsched.predict_start_from_noise(ts, xt, torch.tensor(eps), torch.tensor(t))
    close(back, jsched.predict_start_from_noise(js, jnp.asarray(xt.numpy()), jnp.asarray(eps), jnp.asarray(t)))
    close(back, x0, 1e-3)  # the round trip, in fp32 up to 1/sqrt(abar_999) ~ 200


# ---------------------------------------------------------- apply_model
def _band_key(B):
    """A key whose uniform (B,) draw lands once in each of the four 5% bands
    and once above them."""
    keys = jax.random.split(jax.random.PRNGKey(11), 20000)
    draws = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (B,)))(keys))
    bands = np.digitize(draws, [0.05, 0.1, 0.15, 0.2], right=True)
    hit = np.flatnonzero((np.sort(bands, axis=1) == np.arange(B)).all(axis=1))
    assert hit.size, "no key covers every band"
    return keys[hit[0]], draws[hit[0]]


def test_apply_model_dropout_bands_match(pair):
    """apply_model on 5 targets whose dropout draws fall one in each band
    (all, concat, frustum, CLIP, none), against JAX's apply_model with that
    cond_drop_rng; and the bands are not vacuous: the port's output with the
    draw differs from its output without it on the four dropped views only."""
    p, cfg = pair, pair["cfg"]
    B, H = S - 1, cfg.latent_size
    key, draw = _band_key(B)
    rng = np.random.default_rng(4)
    noisy = rng.normal(size=(B, H, H, 5)).astype(np.float32)
    in_lat = rng.normal(size=(1, H, H, 5)).astype(np.float32)
    clip_v = rng.normal(size=(B, 1, cfg.context_dim + 28)).astype(np.float32)
    jitter = rng.normal(size=(B, H, H, 1)).astype(np.float32)
    t = np.full((B,), 300, np.int32)
    cams, in_cams = _rig(B)
    jm = JViewFusion(p["jcfg"])
    ref = jax.jit(lambda q, *a: jm.apply(q, *a, method=JViewFusion.apply_model))(
        p["params"], jnp.asarray(noisy), JCameras(*map(jnp.asarray, cams)), jnp.asarray(in_lat),
        JCameras(*map(jnp.asarray, in_cams)), jnp.asarray(clip_v), jnp.asarray(t), jax.random.PRNGKey(0), None, key,
        jnp.asarray(jitter))
    args = (torch.tensor(noisy), Cameras(*map(torch.tensor, cams)), torch.tensor(in_lat),
            Cameras(*map(torch.tensor, in_cams)), torch.tensor(clip_v), torch.tensor(t).long(), torch.tensor(jitter))
    with torch.no_grad():
        out = p["model"].apply_model(*args, drop=torch.tensor(draw))
        kept = p["model"].apply_model(*args)
    close(out, ref)
    changed = (out - kept).abs().amax(dim=(1, 2, 3)) > 1e-6
    assert changed.tolist() == [bool(d <= 0.2) for d in draw]


# ------------------------------------------------------------- p_losses
def _jax_draws(key, B, cfg, n_pts):
    """p_losses' draws as the JAX package makes them from `key`."""
    rng_t, rng_noise, rng_attn, rng_drop = jax.random.split(key, 4)
    ls = cfg.latent_size
    t0 = int(jax.random.randint(rng_t, (), 0, cfg.timesteps))
    return dict(t=torch.full((B,), t0, dtype=torch.long),
                noise=torch.tensor(np.asarray(jax.random.normal(rng_noise, (B, ls, ls, 5)))),
                jitter_noise=torch.tensor(np.asarray(jax.random.normal(rng_attn, (B, ls, ls, n_pts)))),
                drop=torch.tensor(np.asarray(jax.random.uniform(rng_drop, (B,)))))


@pytest.mark.parametrize("objective,feed", [("noise", False), ("x_start", False), ("noise", True)],
                         ids=["noise", "x_start", "feed_prev_depth"])
def test_p_losses_matches_with_jax_draws(pair, objective, feed):
    """p_losses on one scene with the JAX side's t, noise, jitter and dropout
    draw (key 5: its dropout draw is checked to drop at least one view)."""
    p = pair
    cfg = dataclasses.replace(p["cfg"], objective=objective)
    jm = JViewFusion(dataclasses.replace(p["jcfg"], objective=objective))
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda q, *a: jm.apply(q, *a, feed_prev_depth=feed, method=JViewFusion.p_losses))(
        p["params"], *_jscene(p["scene"]), key)
    draws = _jax_draws(key, S - 1, cfg, cfg.n_pts_per_ray)
    assert bool((draws["drop"] <= 0.2).any())
    model = p["model"]
    model.cfg = cfg
    try:
        with torch.no_grad():
            loss = model.p_losses(*_tscene(p["scene"]), feed_prev_depth=feed, **draws)
    finally:
        model.cfg = p["cfg"]
    close(loss, ref)
