"""The port's whole model against the JAX package beyond the tiny fp32
checks of tests/test_torch_port_model.py:

- bf16 (fast tier): one apply_model_cfg at `tiny()` with the compute dtype
  bf16 on both sides, the parameters cast as the card and the TPU cast them
  (the port's ViewFusion.cast_for_inference, the JAX package's
  utils/common.py::cast_inference_params), the JAX side compiled with
  xla_allow_excess_precision=False (XLA on the CPU otherwise drops bf16
  roundings). Each side's bf16 chain rounds at ~60 layers; where the two
  order a sum apart, a bf16 rounding can go the other way and the flip
  travels on. So the test holds (a) max|port - JAX| <= BF16_RTOL x
  max|JAX| (the card's kernels-against-plain rule, tools/numerics_check.py)
  and (b) the port's bf16 output no farther from the fp32 output (the port
  in fp32, within 1e-3 of JAX's by tests/test_torch_port_model.py) than the
  JAX bf16 output is, BF16_MEAN_SLACK in the mean: a fault of the size of
  the rounding noise would show in (b).
- Real widths (slow tier): the model's widths (UNet 320/640/1280 with 8
  heads, context 768, GridAttn 256 with 8 heads, CLIP 1024 with 16 heads,
  VAE 128/256/512) at cut depth (one res block a level, three UNet levels,
  one CLIP and one GridAttn layer, 16^2 latents, 2 target views), fp32 on
  both sides, the JAX side through its plain XLA path (fuse_mode "never"):
  JAX-layout parameters loaded into the port by convert/from_jax.py (the
  square 768x768 and 1024x1024 kernels keep their shape when transposed),
  one apply_model_cfg, prepare_batch (the VAE encode and the CLIP tower) and
  one VAE decode, each within 1e-3 x max|JAX| as the tiny checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu.utils.common import cast_inference_params
from mvdfusion_tpu_torch.convert.from_jax import load_flax_params
from mvdfusion_tpu_torch.geometry.cameras import Cameras
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from test_torch_port_model import REL, _jcams, _tcams, flat_flax, nest

BF16_RTOL = 3e-2  # measured 1.90e-2 on the CPU
BF16_MEAN_SLACK = 1.25  # port's mean|bf16 - fp32| over JAX's; measured 0.95
NO_EXCESS = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(cfg, views: int, seed: int = 1):
    """One denoising step's inputs for `views` - 1 targets on a look-at ring."""
    rng = np.random.default_rng(seed)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, views) + 90)
    f, c = np.full((views, 2), 2.1875, np.float32), np.zeros((views, 2), np.float32)
    B, H = views - 1, cfg.latent_size
    return dict(
        noisy=rng.normal(size=(B, H, H, 5)).astype(np.float32),
        in_lat=rng.normal(size=(1, H, H, 5)).astype(np.float32),
        clip_v=rng.normal(size=(B, 1, cfg.context_dim + 28)).astype(np.float32),
        jitter=rng.normal(size=(B, H, H, 1)).astype(np.float32),
        t=np.full((B,), 500, np.int32),
        cams=(R[1:], T[1:], f[1:], c[1:]), in_cams=(R[:1], T[:1], f[:1], c[:1]),
        images=rng.uniform(size=(views, 8 * H, 8 * H, 3)).astype(np.float32), R=R, T=T, f=f, c=c,
    )


def _apply_both(model, jm, params, i, compiler_options=None):
    args = (params, jnp.asarray(i["noisy"]), _jcams(i["cams"]), jnp.asarray(i["in_lat"]), _jcams(i["in_cams"]),
            jnp.asarray(i["clip_v"]), jnp.asarray(i["t"]), jax.random.PRNGKey(0), jnp.asarray(2.5), None,
            jnp.asarray(i["jitter"]))
    f = jax.jit(lambda p, *a: jm.apply(p, *a, method=JViewFusion.apply_model_cfg))
    ref = f.lower(*args).compile(compiler_options=compiler_options)(*args)
    with torch.no_grad():
        out = model.apply_model_cfg(torch.tensor(i["noisy"]), _tcams(i["cams"]), torch.tensor(i["in_lat"]),
                                    _tcams(i["in_cams"]), torch.tensor(i["clip_v"]), torch.tensor(i["t"]).long(),
                                    2.5, torch.tensor(i["jitter"]))
    return out.float().numpy().astype(np.float64), np.asarray(ref, np.float64)


def test_apply_model_cfg_bf16_matches():
    cfg = dataclasses.replace(ViewFusionConfig().tiny(), dtype=torch.bfloat16)
    jcfg = dataclasses.replace(JConfig().tiny(), fuse_mode="interpret", dtype=jnp.bfloat16)
    model = randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()
    flat = flat_flax(model, jcfg)
    i = _inputs(cfg, 4)
    with torch.no_grad():  # the fp32 witness: the same weights at the fp32 compute dtype
        fp32 = randomize_(ViewFusion(ViewFusionConfig().tiny(), device="cpu"), seed=0).eval()
        witness = fp32.apply_model_cfg(torch.tensor(i["noisy"]), _tcams(i["cams"]), torch.tensor(i["in_lat"]),
                                       _tcams(i["in_cams"]), torch.tensor(i["clip_v"]), torch.tensor(i["t"]).long(),
                                       2.5, torch.tensor(i["jitter"])).numpy().astype(np.float64)
    model.cast_for_inference()
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16, torch.float32}
    out, ref = _apply_both(model, JViewFusion(jcfg), cast_inference_params(nest(flat)), i, NO_EXCESS)
    scale, gap = np.abs(ref).max(), np.abs(out - ref)
    ours, theirs = np.abs(out - witness).mean(), np.abs(ref - witness).mean()
    assert gap.max() <= BF16_RTOL * scale, f"max|diff| {gap.max():.4e} against max|JAX| {scale:.4e}"
    assert ours <= BF16_MEAN_SLACK * theirs, f"mean|bf16 - fp32|: port {ours:.4e}, JAX {theirs:.4e}"
    assert gap.max() > 0  # the bf16 chains really ran


def _rel_gap(name, got, ref, readings) -> None:
    """max|got - ref| / max|ref|, logged under `name` and held to REL."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    readings[name] = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
    print(f"{name}: max|diff| / max|JAX| {readings[name]:.3e}")
    assert readings[name] <= REL, (name, readings[name])


def _width_config(cfg):
    return dataclasses.replace(cfg, latent_size=16, unet_num_res_blocks=1, unet_channel_mult=(1, 2, 4),
                               viewattn_layers=1, vae_num_res_blocks=1, clip_layers=1)


@pytest.mark.slow
def test_real_widths_match():
    cfg = _width_config(dataclasses.replace(ViewFusionConfig(), dtype=torch.float32))
    jcfg = _width_config(dataclasses.replace(JConfig(), dtype=jnp.float32, fuse_mode="never"))
    assert (cfg.unet_model_channels, cfg.unet_num_heads, cfg.context_dim, cfg.clip_width, cfg.vae_ch) == \
        (320, 8, 768, 1024, 128)
    model = randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()
    flat = flat_flax(model, jcfg)
    rng = np.random.default_rng(5)  # perturbed, so no square kernel is symmetric in any sense
    flat = {k: v + (0.02 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    load_flax_params(model, flat)
    params = nest(flat)
    del flat
    jm = JViewFusion(jcfg)
    i = _inputs(cfg, 3)
    readings = {}
    out, ref = _apply_both(model, jm, params, i)
    _rel_gap("apply_model_cfg", out, ref, readings)
    keys = ("images", "R", "T", "f", "c")
    idx = (np.array([0]), np.array([1, 2]))
    jref = jax.jit(lambda q, *a: jm.apply(q, *a, method=JViewFusion.prepare_batch))(
        params, *(jnp.asarray(i[k]) for k in keys), *map(jnp.asarray, idx))
    with torch.no_grad():
        got = model.prepare_batch(*(torch.as_tensor(i[k]) for k in keys), *map(torch.as_tensor, idx))
    for name, o, r in zip(("latents", "cameras", "input_latents", "input_cameras", "clip"), got, jref):
        parts = zip(Cameras._fields, o, r) if isinstance(o, Cameras) else [("", o, r)]
        for field, a, b in parts:
            _rel_gap(f"prepare_batch {name} {field}".strip(), a, b, readings)
    z = np.asarray(jref[0])[..., :4]
    img_ref = jax.jit(lambda q, a: jm.apply(q, a, method=JViewFusion.decode_latents))(params, jnp.asarray(z))
    with torch.no_grad():
        img = model.decode_latents(torch.tensor(z))
    assert tuple(img.shape) == (2, 128, 128, 3)
    _rel_gap("decode_latents", img, img_ref, readings)
