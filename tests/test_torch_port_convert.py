"""The port's reference-checkpoint loaders (convert/reference.py) against
the JAX package's (convert/torch_to_flax.py), at the tiny config in fp32 on
the CPU.

Files are synthesized with torch.save from seeded port models: the whole
ViewFusion with the dead keys a real mvdfusion_sep23.pt carries, a
pre-surgery zero123 UNet, a first_stage_model.-prefixed SD VAE, a
TorchScript archive with CLIP's visual.* and text keys, and the legacy
cc_projection. Each file goes through both loaders; the JAX side writes
flax params (templates made from a port model through the JAX package's
TRANSFORMS, so no flax init is needed) and runs on its plain reference
path. Loaded parameters must be equal bit for bit through the mapping; one
apply_model_cfg on each side agrees to 1e-3 x max|JAX|, the tolerance of
test_torch_port_model.py (fp32 through ~60 layers, sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.convert import torch_to_flax as J
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.convert.torch_reader import read_torch_checkpoint
from mvdfusion_tpu.geometry.cameras import Cameras as JCameras
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu_torch.convert import reference as P
from mvdfusion_tpu_torch.convert.surgery import ZERO123_PARAM_MAPPER, ZERO123_REMOVE_KEYS
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_

REL = 1e-3
S, IMG = 4, 64

# keys a real mvdfusion_sep23.pt carries that no parameter takes
# (tests/test_convert_full.py::EXPECTED_DEAD_PREFIXES); any shapes do
DEAD = {
    "scheduler.betas": (1000,),
    "scheduler.alphas_cumprod": (1000,),
    "view_attn.t_embedder.mlp.0.weight": (32, 256),
    "view_attn.t_embedder.mlp.0.bias": (32,),
    "clip_image_encoder.model.token_embedding.weight": (10, 64),
    "clip_image_encoder.model.positional_embedding": (7, 64),
    "clip_image_encoder.model.ln_final.weight": (64,),
    "clip_image_encoder.model.text_projection": (64, 64),
    "clip_image_encoder.model.logit_scale": (),
}


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


def configs(**kw):
    return dataclasses.replace(ViewFusionConfig().tiny(), **kw), dataclasses.replace(JConfig().tiny(), **kw)


def port_model(cfg, seed):
    return randomize_(ViewFusion(cfg, device="cpu"), seed=seed).eval()


def flax_flat(model, jcfg):
    """The port model's parameters as flat {"a/b/c": array} flax params; the
    legacy cc layer, which the JAX mapping does not list, carried by hand."""
    sd = {k: v.detach().float().numpy() for k, v in model.state_dict().items()}
    out = {}
    for fp, (tk, tf) in viewfusion_mapping(jcfg).items():
        if not jcfg.embed_camera_pose and fp[0].startswith("cc_layers_"):
            continue
        out["/".join(fp)] = TRANSFORMS[tf](sd[tk]).astype(np.float32)
    if not jcfg.embed_camera_pose:
        out["cc_layers_0/kernel"] = sd["cc_projection.weight"].T
        out["cc_layers_0/bias"] = sd["cc_projection.bias"]
    return out


def nest(flat):
    tree = {}
    for path, leaf in flat.items():
        d = tree
        *head, last = path.split("/")
        for p in head:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(leaf)
    return {"params": tree}


def unnest(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path[1:]): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def assert_same_params(model, jcfg, jparams, prefix=""):
    """The port model's parameters, through the mapping, equal the JAX
    side's flax params bit for bit (those under `prefix`)."""
    ours, theirs = flax_flat(model, jcfg), unnest(jparams)
    keys = [k for k in ours if k.startswith(prefix)]
    assert keys
    bad = [k for k in keys if not np.array_equal(ours[k], theirs[k])]
    assert bad == [], bad[:5]


def dead_keys():
    rng = np.random.default_rng(9)
    return {k: torch.tensor(rng.normal(size=s).astype(np.float32)) for k, s in DEAD.items()}


def step_inputs(cfg, pose_dim=28):
    rng = np.random.default_rng(1)
    B, H = 3, cfg.latent_size
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    f, c = np.full((S, 2), 2.1875, np.float32), np.zeros((S, 2), np.float32)
    return dict(
        noisy=rng.normal(size=(B, H, H, 5)).astype(np.float32),
        in_lat=rng.normal(size=(1, H, H, 5)).astype(np.float32),
        clip_v=rng.normal(size=(B, 1, cfg.context_dim + pose_dim)).astype(np.float32),
        jitter=rng.normal(size=(B, H, H, 1)).astype(np.float32),
        t=np.full((B,), 500, np.int32),
        cams=(R[1:], T[1:], f[1:], c[1:]), in_cams=(R[:1], T[:1], f[:1], c[:1]),
    )


def run_both(model, jcfg, jparams, i):
    """apply_model_cfg at CFG 2.5 on the port model and on the JAX model."""
    jc = lambda a: JCameras(*(jnp.asarray(x, jnp.float32) for x in a))
    tc = lambda a: Cameras(*(torch.as_tensor(np.asarray(x, np.float32)) for x in a))
    jm = JViewFusion(jcfg)
    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=JViewFusion.apply_model_cfg))(
        jparams, jnp.asarray(i["noisy"]), jc(i["cams"]), jnp.asarray(i["in_lat"]), jc(i["in_cams"]),
        jnp.asarray(i["clip_v"]), jnp.asarray(i["t"]), jax.random.PRNGKey(0), jnp.asarray(2.5), None,
        jnp.asarray(i["jitter"]))
    with torch.no_grad():
        out = model.apply_model_cfg(torch.tensor(i["noisy"]), tc(i["cams"]), torch.tensor(i["in_lat"]),
                                    tc(i["in_cams"]), torch.tensor(i["clip_v"]), torch.tensor(i["t"]).long(),
                                    2.5, torch.tensor(i["jitter"]))
    return out, ref


# ------------------------------------------------------------ 1. full file
def test_full_checkpoint_loads_as_the_jax_loader_does(tmp_path):
    """A reference-layout file (a seeded model's state plus the dead keys)
    through both load_viewfusion calls: the same file keys written, none
    missing, the unused set exactly the dead set on both sides, the
    parameters equal through the mapping, and apply_model_cfg within 1e-3
    relative. The JAX stats count flax leaves (CLIP's packed in_proj feeds
    three), so the written count is compared in file keys."""
    cfg, jcfg = configs()
    src = port_model(cfg, 0)
    path = str(tmp_path / "mvdfusion_sep23.pt")
    torch.save({**src.state_dict(), **dead_keys()}, path)

    dst = port_model(cfg, 1)
    stats = P.load_viewfusion(dst, path, verbose=False)
    assert stats.missing == [] and set(stats.unused) == set(DEAD)
    assert len(stats.written) == len(src.state_dict())
    sd, ref = dst.state_dict(), src.state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in ref)

    jparams, jstats = J.load_viewfusion(nest(flax_flat(port_model(cfg, 2), jcfg)), jcfg, path, verbose=False,
                                        return_stats=True)
    table = viewfusion_mapping(jcfg)
    assert jstats.missing_flax == [] and jstats.missing_torch == [] and jstats.untouched_flax == []
    assert len({table[p[1:]][0] for p in jstats.wrote}) == len(stats.written)
    assert set(jstats.unused_torch) == set(stats.unused) == set(DEAD)
    assert_same_params(dst, jcfg, jparams)
    rel_close(*run_both(dst, jcfg, jparams, step_inputs(cfg)))


# ----------------------------------------------------------- 2. strictness
def _strict_case(name, tmp_path):
    """(a loader call that must raise, the exception, a pattern of its message)."""
    cfg, _ = configs()
    if name in ("missing_key", "wrong_shape"):
        model = port_model(cfg, 0)
        state = dict(model.state_dict())
        key = "view_attn.final_layer_b.weight"
        if name == "missing_key":
            del state[key]
        else:
            state[key] = torch.zeros(3, 5)
        path = str(tmp_path / "sep23.pt")
        torch.save(state, path)
        return (lambda: P.load_viewfusion(model, path, verbose=False),
                KeyError if name == "missing_key" else ValueError, key)
    legacy = name == "cc_stray_key"
    model = port_model(dataclasses.replace(cfg, embed_camera_pose=not legacy), 0)
    d = cfg.context_dim
    sd = {"cc_projection.weight": torch.zeros(d, d + 4), "cc_projection.bias": torch.zeros(d)}
    if legacy:
        sd["unet_model.stray.weight"] = torch.zeros(3)
    path = str(tmp_path / "zero123_cc.ckpt")
    torch.save({"state_dict": sd}, path)
    return (lambda: P.load_zero123_cc(model, path, verbose=False), ValueError,
            "unet_model.stray.weight" if legacy else "embed_camera_pose=True")


@pytest.mark.parametrize("name", ["missing_key", "wrong_shape", "cc_stray_key", "cc_embed_camera_pose"])
def test_strict_loads_raise_naming_the_key(tmp_path, name):
    """A file missing one parameter under strict, a wrong shape, a stray key
    in the cc file and the cc file on a model with embed_camera_pose=True
    raise, naming what is wrong."""
    call, exc, pattern = _strict_case(name, tmp_path)
    with pytest.raises(exc, match=pattern.replace(".", r"\.")):
        call()


def test_failed_load_writes_nothing(tmp_path):
    """A load that raises on a shape leaves every parameter as it was: the
    shapes are checked before the first copy."""
    cfg, _ = configs()
    model, src = port_model(cfg, 0), port_model(cfg, 1)
    state = dict(src.state_dict())
    state["view_attn.final_layer_b.weight"] = torch.zeros(3, 5)
    path = str(tmp_path / "sep23.pt")
    torch.save(state, path)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError):
        P.load_viewfusion(model, path, verbose=False)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())


# --------------------------------------------------------- 3. file formats
def _format_state():
    g = torch.Generator().manual_seed(0)
    base = torch.arange(48, dtype=torch.float32).reshape(6, 8)
    return {
        "w_fp32": torch.randn(4, 5, generator=g),
        "w_i64": torch.arange(10),
        "w_bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
    }, {
        "half": {"w_fp16": torch.randn(3, 7, generator=g).half(), "w_bf16": torch.randn(5, 3, generator=g).bfloat16()},
        "views": {"shared_a": base[1:4], "shared_b": base.t(), "strided": torch.randn(6, 4, generator=g).t()},
    }


def _as_f64(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to(torch.float64).numpy()
    return np.asarray(v).astype(np.float64)


def _unwrap(obj):
    for key in ("model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            return obj[key]
    return obj


@pytest.mark.parametrize("fmt", ["zipfile", "nested", "legacy", "half", "views", "torchscript"])
def test_file_formats_read_alike(tmp_path, fmt):
    """One file per format through the port's load_torch_state and through
    the JAX package's torch-free reader: the same keys and equal values
    (fp16 and bf16 storages, strided views and shared storages, the
    pre-zipfile format, a nested state_dict and a TorchScript archive)."""
    plain, extra = _format_state()
    path = str(tmp_path / f"{fmt}.pt")
    if fmt == "torchscript":
        mod = torch.jit.script(torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4),
                                                   torch.nn.Linear(4, 2)))
        torch.jit.save(mod, path)
        state = {k: v for k, v in torch.jit.load(path).state_dict().items()}
    else:
        state = {**plain, **extra.get(fmt, {})}
        if fmt == "nested":
            torch.save({"state_dict": state, "global_step": 7}, path)
        else:
            torch.save(state, path, _use_new_zipfile_serialization=fmt != "legacy")
    ours = P.load_torch_state(path)
    theirs = _unwrap(read_torch_checkpoint(path))
    assert set(ours) == set(theirs) == set(state)
    for k, v in state.items():
        assert tuple(ours[k].shape) == tuple(v.shape) == np.shape(theirs[k]), k
        np.testing.assert_array_equal(_as_f64(ours[k]), _as_f64(v), err_msg=k)
        np.testing.assert_array_equal(_as_f64(theirs[k]), _as_f64(v), err_msg=k)
        assert ours[k].dtype == v.dtype, k


# ------------------------------------------------------- 4. zero123 surgery
def test_zero123_unet_surgery_loads_as_the_jax_loader_does(tmp_path):
    """A pre-surgery zero123 file: the UNet without its grafted
    aligned_attn_* layers, the middle block's second ResBlock and the two
    upsample convs at their positions before the grafts, the in/out convs
    at SD's 8-in/4-out shapes, all under model.diffusion_model., beside a
    VAE and a text-encoder key. tiny() with two res blocks a level is the
    smallest config with middle_block.3 and output_blocks.5.3 / 8.3. Both
    loaders write the same values, leave the same rows at their initial
    values and leave the same file keys unused."""
    cfg, jcfg = configs(unet_num_res_blocks=2)
    src, dst = port_model(cfg, 0), port_model(cfg, 1)
    inv = {v: k for k, v in ZERO123_PARAM_MAPPER.items()}
    pre = P.UNET_PREFIX
    state = {}
    for k, v in src.state_dict().items():
        if not k.startswith(pre) or "aligned_attn_" in k or k[len(pre):] in ZERO123_REMOVE_KEYS:
            continue
        state["model.diffusion_model." + inv.get(k[len(pre):], k[len(pre):])] = v
    assert "model.diffusion_model.middle_block.2.in_layers.0.weight" in state
    assert "model.diffusion_model.output_blocks.8.2.conv.weight" in state
    mc = cfg.unet_model_channels
    g = torch.Generator().manual_seed(3)
    stock = {"input_blocks.0.0.weight": (mc, 8, 3, 3), "out.2.weight": (4, mc, 3, 3), "out.2.bias": (4,)}
    for k, shape in stock.items():
        state["model.diffusion_model." + k] = torch.randn(shape, generator=g)
    state["first_stage_model.encoder.conv_in.bias"] = torch.zeros(4)
    state["cond_stage_model.model.ln_final.weight"] = torch.ones(4)
    path = str(tmp_path / "zero123_105000.ckpt")
    torch.save({"state_dict": state}, path)

    before = {k: v.clone() for k, v in dst.state_dict().items()}
    stats = P.load_zero123_unet(dst, path, verbose=False)
    jparams, jstats = J.load_zero123_unet(nest(flax_flat(port_model(cfg, 1), jcfg)), jcfg, path, verbose=False,
                                          return_stats=True)
    kept = {k[len(pre):] for k in stats.missing}
    assert kept == set(jstats.missing_torch)
    assert set(ZERO123_REMOVE_KEYS) <= kept and all("aligned_attn_" in k or k in ZERO123_REMOVE_KEYS for k in kept)
    assert any("aligned_attn_" in k for k in kept)
    assert set(stats.unused) == set(jstats.unused_torch) == {"first_stage_model.encoder.conv_in.bias",
                                                             "cond_stage_model.model.ln_final.weight"}
    sd, ref = dst.state_dict(), src.state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in stats.written)
    assert all(torch.equal(sd[k], before[k]) for k in sd if k not in stats.written)
    assert len(stats.written) + len(stats.missing) == sum(k.startswith(pre) for k in sd)
    assert_same_params(dst, jcfg, jparams, prefix="unet/")


# ------------------------------------------------------------ 5. VAE, CLIP
class _Holder(torch.nn.Module):
    """A module tree holding named parameters only (a TorchScript archive
    of it carries its state dict, as the OpenAI CLIP archive does)."""

    def forward(self, x):
        return x


def _holder(state):
    root = _Holder()
    for key, v in state.items():
        *path, leaf = key.split(".")
        m = root
        for p in path:
            if not hasattr(m, p):
                m.add_module(p, torch.nn.Module())
            m = getattr(m, p)
        m.register_parameter(leaf, torch.nn.Parameter(v.detach().clone(), requires_grad=False))
    return root


@pytest.mark.parametrize("which", ["sd_vae", "clip"])
def test_vae_and_clip_load_as_the_jax_loaders_do(tmp_path, which):
    """load_sd_vae on a first_stage_model.-prefixed file (with a UNet key
    beside it) and load_clip on a TorchScript archive of visual.* plus the
    text tower's keys: the port's and the JAX package's loaders write the
    same values and leave the same file keys unused."""
    cfg, jcfg = configs()
    src, dst = port_model(cfg, 0), port_model(cfg, 1)
    path = str(tmp_path / f"{which}.ckpt")
    if which == "sd_vae":
        state = {"first_stage_model." + k[len("vae."):]: v for k, v in src.state_dict().items()
                 if k.startswith("vae.")}
        state["model.diffusion_model.out.2.bias"] = torch.zeros(4)
        torch.save({"state_dict": state}, path)
        extra = {"model.diffusion_model.out.2.bias"}
        stats = P.load_sd_vae(dst, path, verbose=False)
        jparams, jstats = J.load_sd_vae(nest(flax_flat(port_model(cfg, 1), jcfg)), jcfg, path, verbose=False,
                                        return_stats=True)
        prefix, scope = "vae/", "vae."
    else:
        p = "clip_image_encoder.model."
        state = {k[len(p):]: v for k, v in src.state_dict().items() if k.startswith(p + "visual.")}
        g = torch.Generator().manual_seed(4)
        extra = {"token_embedding.weight": (10, 64), "positional_embedding": (7, 64), "ln_final.weight": (64,),
                 "transformer.resblocks.0.attn.in_proj_weight": (192, 64), "text_projection": (64, 64)}
        state.update({k: torch.randn(s, generator=g) for k, s in extra.items()})
        torch.jit.save(torch.jit.script(_holder(state)), path)
        stats = P.load_clip(dst, path, verbose=False)
        jparams, jstats = J.load_clip(nest(flax_flat(port_model(cfg, 1), jcfg)), jcfg, path, verbose=False,
                                      return_stats=True)
        prefix, scope = "clip/", p
    assert stats.missing == [] and jstats.missing_torch == [] and jstats.missing_flax == []
    assert set(stats.unused) == set(jstats.unused_torch) == set(extra)
    sd, ref = dst.state_dict(), src.state_dict()
    assert len(stats.written) == sum(k.startswith(scope) for k in sd)
    assert all(torch.equal(sd[k], ref[k]) for k in stats.written)
    assert_same_params(dst, jcfg, jparams, prefix=prefix)


# ------------------------------------------------------ 6. legacy pose path
def test_legacy_pose_path_matches(tmp_path):
    """embed_camera_pose=False on both sides: the cc layer from a
    zero123_cc file through both load_zero123_cc calls, prepare_batch with
    the rig's azimuths and elevations against JAX's (the delta-pose
    clip_v_embed and the latents), then one apply_model_cfg, 1e-3
    relative."""
    cfg, jcfg = configs(embed_camera_pose=False)
    model = port_model(cfg, 0)
    assert set(k for k in model.state_dict() if k.startswith("cc_projection")) == {
        "cc_projection.weight", "cc_projection.bias"}
    d = cfg.context_dim
    rng = np.random.default_rng(3)
    sd = {"cc_projection.weight": torch.tensor((rng.normal(size=(d, d + 4)) / d**0.5).astype(np.float32)),
          "cc_projection.bias": torch.tensor((0.02 * rng.normal(size=(d,))).astype(np.float32))}
    path = str(tmp_path / "zero123_105000_cc.ckpt")
    torch.save({"state_dict": sd}, path)
    stats = P.load_zero123_cc(model, path, verbose=False)
    assert sorted(stats.written) == sorted(sd) and stats.unused == [] and stats.missing == []
    jparams = J.load_zero123_cc(nest(flax_flat(port_model(cfg, 5), jcfg)), jcfg, path, verbose=False)
    # every other leaf from the port model itself
    flat = {**flax_flat(model, jcfg), **{k: v for k, v in unnest(jparams).items() if k.startswith("cc_layers_0")}}
    jparams = nest(flat)
    assert_same_params(model, jcfg, jparams)

    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    scene = dict(images=np.random.default_rng(0).uniform(size=(S, IMG, IMG, 3)).astype(np.float32), R=R, T=T,
                 f=np.full((S, 2), 2.1875, np.float32), c=np.zeros((S, 2), np.float32),
                 input_idx=np.array([0]), target_idx=np.array([1, 2, 3]))
    pose = dict(azimuth=np.deg2rad(np.linspace(0, 315, S)).astype(np.float32),
                elevation=np.deg2rad(np.array([30.0, 10.0, -20.0, 45.0])).astype(np.float32))
    keys = ("images", "R", "T", "f", "c", "input_idx", "target_idx")
    jm = JViewFusion(jcfg)
    ref = jax.jit(lambda q, *a, **k: jm.apply(q, *a, **k, method=JViewFusion.prepare_batch))(
        jparams, *(jnp.asarray(scene[k]) for k in keys), **{k: jnp.asarray(v) for k, v in pose.items()})
    with torch.no_grad():
        out = model.prepare_batch(*(torch.as_tensor(np.asarray(scene[k])) for k in keys),
                                  **{k: torch.as_tensor(v) for k, v in pose.items()})
    assert tuple(out[4].shape) == (3, 1, d + 4)
    for i in (0, 2, 4):  # latents, input latents, clip_v_embed
        rel_close(out[i], ref[i])
    i = step_inputs(cfg, pose_dim=4)
    rel_close(*run_both(model, jcfg, jparams, i))
    with pytest.raises(ValueError, match="azimuth"):
        model.prepare_batch(*(torch.as_tensor(np.asarray(scene[k])) for k in keys))


def test_from_jax_table_carries_the_legacy_layer():
    """convert/from_jax.py maps flax cc_layers_0 onto the legacy
    cc_projection.{weight,bias}: JAX-layout params carried by the table load
    back into a fresh legacy model bit for bit."""
    from mvdfusion_tpu_torch.convert.from_jax import load_flax_params, viewfusion_table

    cfg, jcfg = configs(embed_camera_pose=False)
    model = port_model(cfg, 0)
    assert set(viewfusion_table(cfg)) == set(model.state_dict())
    fresh = ViewFusion(cfg, device="cpu")
    load_flax_params(fresh, flax_flat(model, jcfg))
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items())


def test_chip_smoke_weights_rehearsal_on_cpu(tmp_path):
    """chip_smoke.py's weights phase at the tiny config on the CPU: the same
    files, loads and checks as on the card, minus the launch counts."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    counts = chip_smoke.run_weights("cpu", device="cpu", cfg=ViewFusionConfig().tiny(), out_dir=tmp_path)
    assert counts == {} and list(tmp_path.iterdir()) == []
