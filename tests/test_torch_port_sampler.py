"""The rest of the port's DDIM sampler against the JAX package's, and the
demo's --ckpt, at the tiny config in fp32 on the CPU.

The schedule: make_ddim_timesteps and make_ddim_schedule at S in {10, 50},
eta in {0, 0.5, 1}, uniform and quad timesteps; timesteps exactly equal,
the float32 tables within 1e-6 relative (the same float64 formula).
Trajectories: four shared-noise steps at eta 0 (uniform), eta 0.5 (quad)
and with a latent clamp, then eval_scenes at eta 0.5, each within 1e-3 x
max|JAX| (fp32 through ~60 layers, sums in another order; the tolerance of
test_torch_port_model.py). One seeded port model's parameters feed the JAX
side through the JAX package's TRANSFORMS; JAX runs its plain reference
path. The JAX sampler takes no `method`: its quad trajectory runs the
sampler's body with its module's make_ddim_schedule patched to quad.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.pipeline.sampler as jsampler
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.core import schedule as jsched
from mvdfusion_tpu.geometry.cameras import Cameras as JCameras
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu.pipeline.eval import eval_scenes as j_eval_scenes
from mvdfusion_tpu_torch.core import schedule as tsched
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.pipeline.eval import eval_scenes
from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample

REL = 1e-3
S, IMG, STEPS = 4, 64, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_close(got, ref, tol=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1e-6), f"max|diff| {err:.3e} vs max|ref| {scale:.3e}"


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("method", ["uniform", "quad"])
@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("steps", [10, 50])
def test_ddim_schedule_matches(steps, eta, method):
    ts = tsched.make_ddim_timesteps(steps, 1000, method)
    np.testing.assert_array_equal(ts, jsched.make_ddim_timesteps(steps, 1000, method))
    ours = tsched.make_ddim_schedule(1000, steps, eta=eta, method=method)
    ref = jsched.make_ddim_schedule(1000, steps, eta=eta, method=method)
    np.testing.assert_array_equal(ours.timesteps.numpy(), np.asarray(ref.timesteps))
    for name in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    if eta == 0:
        assert not ours.sigmas.any()


def test_unknown_discretization_raises():
    for make in (tsched.make_ddim_timesteps, jsched.make_ddim_timesteps):
        with pytest.raises(NotImplementedError, match="cubic"):
            make(10, 1000, "cubic")


# ----------------------------------------------------------- trajectories
@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = ViewFusionConfig().tiny(), JConfig().tiny()
    model = randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = {}
    for fp, (tk, tf) in viewfusion_mapping(jcfg).items():
        d = tree
        for p in fp[:-1]:
            d = d.setdefault(p, {})
        d[fp[-1]] = jnp.asarray(TRANSFORMS[tf](sd[tk]).astype(np.float32))
    rng = np.random.default_rng(7)
    B, H = S - 1, cfg.latent_size
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    f, c = np.full((S, 2), 2.1875, np.float32), np.zeros((S, 2), np.float32)
    return dict(
        cfg=cfg, model=model, jm=JViewFusion(jcfg), params={"params": tree},
        scene=dict(images=rng.uniform(size=(S, IMG, IMG, 3)).astype(np.float32), R=R, T=T, f=f, c=c),
        cams=(R[1:], T[1:], f[1:], c[1:]), in_cams=(R[:1], T[:1], f[:1], c[:1]),
        in_lat=(rng.normal(size=(1, H, H, 5)) * 0.5).astype(np.float32),
        clip_v=(rng.normal(size=(B, 1, cfg.context_dim + 28)) * 0.3).astype(np.float32),
        init=rng.normal(size=(B, H, H, 5)).astype(np.float32),
        step_noise=rng.normal(size=(STEPS, B, H, H, 5)).astype(np.float32),
        jitter=rng.normal(size=(STEPS, B, H, H, 1)).astype(np.float32),
    )


TRAJECTORIES = {  # name: (eta, method, x_clip)
    "eta0": (0.0, "uniform", None),
    "eta0.5_quad": (0.5, "quad", None),
    "x_clip": (1.0, "uniform", 1.5),
}


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_ddim_trajectory_matches(pair, monkeypatch, name):
    """Four DDIM steps at CFG 2.5 from shared init, step and jitter noise:
    every pred_x0 and the final latents, 1e-3 relative. The clamp case
    ends on its bound (it did clamp)."""
    eta, method, x_clip = TRAJECTORIES[name]
    p = pair
    jc = lambda a: JCameras(*(jnp.asarray(x, jnp.float32) for x in a))
    tc = lambda a: Cameras(*(torch.as_tensor(np.asarray(x, np.float32)) for x in a))
    sample = jsampler.ddim_sample
    if method != "uniform":
        monkeypatch.setattr(jsampler, "make_ddim_schedule",
                            functools.partial(jsched.make_ddim_schedule, method=method))
        sample = jsampler.ddim_sample.__wrapped__  # the patched schedule, not a cached trace
    ref = sample(p["params"], p["jm"], jc(p["cams"]), jnp.asarray(p["in_lat"]), jc(p["in_cams"]),
                 jnp.asarray(p["clip_v"]), jax.random.PRNGKey(0), jnp.asarray(2.5), num_steps=STEPS, eta=eta,
                 return_trajectory=True, init_noise=jnp.asarray(p["init"]), step_noise=jnp.asarray(p["step_noise"]),
                 jitter_noise=jnp.asarray(p["jitter"]), x_clip=None if x_clip is None else jnp.asarray(x_clip))
    res = ddim_sample(p["model"], tc(p["cams"]), torch.tensor(p["in_lat"]), tc(p["in_cams"]),
                      torch.tensor(p["clip_v"]), 2.5, num_steps=STEPS, eta=eta, method=method,
                      return_trajectory=True, init_noise=torch.tensor(p["init"]),
                      step_noise=torch.tensor(p["step_noise"]), jitter_noise=torch.tensor(p["jitter"]), x_clip=x_clip)
    rel_close(res.pred_x0_trajectory, ref.pred_x0_trajectory)
    rel_close(res.latents, ref.latents)
    if x_clip is not None:
        assert res.latents.abs().max().item() == x_clip
    if eta == 0:  # deterministic: other step noise, the same latents
        again = ddim_sample(p["model"], tc(p["cams"]), torch.tensor(p["in_lat"]), tc(p["in_cams"]),
                            torch.tensor(p["clip_v"]), 2.5, num_steps=STEPS, eta=0.0, method=method,
                            init_noise=torch.tensor(p["init"]), step_noise=torch.randn(p["step_noise"].shape),
                            jitter_noise=torch.tensor(p["jitter"]))
        assert torch.equal(again.latents, res.latents)


def test_eval_scenes_eta_matches(pair):
    """eval_scenes at eta 0.5 on one scene (1 input, 3 targets) against the
    JAX package's, on the noise the JAX sampler draws from the scene's key;
    every EvalOutput field 1e-3 relative."""
    p = pair
    sc = p["scene"]
    B, H = S - 1, p["cfg"].latent_size
    key = jax.random.PRNGKey(11)
    ref = j_eval_scenes(p["params"], p["jm"], *(jnp.asarray(sc[k])[None] for k in ("images", "R", "T", "f", "c")),
                        jnp.asarray([0]), jnp.asarray([1, 2, 3]), key[None], jnp.asarray(2.5), num_steps=STEPS,
                        eta=0.5)
    _, init_rng, z_rng, jit_rng = jax.random.split(key, 4)  # the JAX sampler's draws
    noise = dict(init_noise=jax.random.normal(init_rng, (B, H, H, 5)),
                 step_noise=jax.random.normal(z_rng, (STEPS, B, H, H, 5)),
                 jitter_noise=jax.random.normal(jit_rng, (STEPS, B, H, H, 1)))
    out = eval_scenes(p["model"], *(torch.as_tensor(sc[k])[None] for k in ("images", "R", "T", "f", "c")),
                      torch.tensor([0]), torch.tensor([1, 2, 3]), 2.5, num_steps=STEPS, eta=0.5,
                      **{k: torch.as_tensor(np.array(v))[None] for k, v in noise.items()})
    for k in out._fields:
        rel_close(getattr(out, k), getattr(ref, k))


# ------------------------------------------------------------ demo --ckpt
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_restores_a_trainer_checkpoint(tmp_path, monkeypatch, capsys):
    """cli/train.py takes one optimizer step at the tiny config on a fake
    GSO directory and saves; cli/demo.py --ckpt <its ckpt dir> restores
    that checkpoint's params (every parameter equal to them after the
    restore, the restore logged) and its scene's metrics differ from a run
    whose --ckpt does not exist, which keeps the random-weights line."""
    import yaml

    from mvdfusion_tpu_torch.cli import demo, train
    from mvdfusion_tpu_torch.core.checkpoint import restore_checkpoint
    from mvdfusion_tpu_torch.pipeline import trainer

    cs = _chip_smoke()
    cs.write_gso(tmp_path / "gso", 1, 64, seed=0)
    path = cs.train_config(tmp_path, 64, save_interval=1)
    cfg = yaml.safe_load(path.read_text())
    cfg["trainer"].update(grad_accum_step=1, scenes_per_chip=1)
    path.write_text(yaml.safe_dump(cfg))
    train.main(["-c", str(path), "--tiny", "--device", "cpu", "--seed", "3", "--max-steps", "1"])
    ckpt_dir = tmp_path / "exp" / "ckpt"
    step = ckpt_dir / "step_00000001"
    assert step.exists()
    saved = restore_checkpoint(step)["params"]

    restored = []
    load = trainer.load_params

    def spy(model, params):
        load(model, params)
        restored.append(all(torch.equal(p, saved[n].to(p.dtype)) for n, p in model.named_parameters()))

    monkeypatch.setattr(trainer, "load_params", spy)
    metrics = {}
    for name, ckpt in (("restored", ckpt_dir), ("random", tmp_path / "absent")):
        capsys.readouterr()
        demo.main(["-c", str(path), "--tiny", "--device", "cpu", "--steps", "1", "--eval-num", "1",
                   "--ckpt", str(ckpt)])
        log = capsys.readouterr().out
        if name == "restored":
            assert f"[demo] restoring {step}" in log and restored == [True]
        else:
            assert "no checkpoint found" in log and restored == [True]
        vis = tmp_path / "exp" / cfg["inference"]["vis_dir"]
        metrics[name] = json.loads((vis / "metrics.json").read_text())["summary"]
        assert all(np.isfinite(v) for v in metrics[name].values())
    assert metrics["restored"] != metrics["random"]
    with pytest.raises(FileNotFoundError, match="latest"):
        os.remove(ckpt_dir / "latest")
        demo.main(["-c", str(path), "--tiny", "--device", "cpu", "--ckpt", str(ckpt_dir)])
