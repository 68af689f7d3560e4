"""The PyTorch port's pure functions and building blocks against the JAX package.

Every test makes its inputs from a seed with numpy and hands the same arrays
to the JAX function and to its counterpart in mvdfusion_tpu_torch, on the CPU
in fp32. Tolerances: 1e-5 max-abs for closed-form functions (the same float32
formula, at most a few ulps of reassociation), 1e-4 for modules with
reductions over up to a few hundred elements (different sum order).
The package-hygiene tests at the end scan the port's sources.
"""

import ast
import re
from pathlib import Path

import flax.linen as jnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.core import schedule as jsched
from mvdfusion_tpu.geometry import cameras as jcam
from mvdfusion_tpu.geometry import gridsample as jgrid
from mvdfusion_tpu.geometry import harmonics as jharm
from mvdfusion_tpu.geometry import rays as jrays
from mvdfusion_tpu.nn import layers as jl
from mvdfusion_tpu.ops import image as jimg
from mvdfusion_tpu.utils import common as jcommon
from mvdfusion_tpu_torch.core import schedule as tsched
from mvdfusion_tpu_torch.geometry import cameras as tcam
from mvdfusion_tpu_torch.geometry import gridsample as tgrid
from mvdfusion_tpu_torch.geometry import harmonics as tharm
from mvdfusion_tpu_torch.geometry import rays as trays
from mvdfusion_tpu_torch.nn import layers as tl
from mvdfusion_tpu_torch.nn.unet import Upsample
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops import image as timg
from mvdfusion_tpu_torch.utils import common as tcommon

REPO = Path(__file__).resolve().parents[1]
CLOSED = 1e-5  # same float32 formula on both sides
MODULE = 1e-4  # reductions in a different order


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol, f"max|diff| {err:.3e} > {tol:g}"


def T(a):
    return torch.as_tensor(np.asarray(a))


def _rig(n, dist=1.5):
    R, Tr = jcam.look_at_view_transform(dist=dist, elev=30.0, azim=np.linspace(0, 315, n) + 90)
    f = np.full((n, 2), 2.1875, np.float32)
    c = np.random.default_rng(3).normal(size=(n, 2)).astype(np.float32) * 0.05
    return R, Tr, f, c


# ------------------------------------------------------------------ schedule
def test_ddpm_tables_match():
    js, ts = jsched.make_ddpm_schedule(), tsched.make_ddpm_schedule()
    for name in js._fields:
        close(getattr(ts, name), getattr(js, name), 0.0)


@pytest.mark.parametrize("steps", [4, 50])
def test_ddim_schedule_and_step_match(rng, steps):
    jd = jsched.make_ddim_schedule(1000, steps, eta=1.0)
    td = tsched.make_ddim_schedule(1000, steps)
    np.testing.assert_array_equal(np.asarray(td.timesteps), np.asarray(jd.timesteps))
    assert int(td.timesteps[0]) == 1  # the SD +1 offset
    for name in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        close(getattr(td, name), getattr(jd, name), 0.0)
    x, eps, z = (rng.normal(size=(2, 4, 4, 5)).astype(np.float32) for _ in range(3))
    for index in (0, steps // 2, steps - 1):
        jx, jx0 = jsched.ddim_step(jd, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(index), jnp.asarray(z))
        tx, tx0 = tsched.ddim_step(td, T(x), T(eps), index, T(z))
        close(tx, jx, CLOSED)
        close(tx0, jx0, CLOSED)


# ------------------------------------------------------------------ geometry
def test_look_at_view_transform_matches():
    for a, b in zip(tcam.look_at_view_transform(dist=2.0, elev=[10.0, 80.0], azim=[30.0, 200.0]),
                    jcam.look_at_view_transform(dist=2.0, elev=[10.0, 80.0], azim=[30.0, 200.0])):
        np.testing.assert_array_equal(a, b)


def test_cameras_project_unproject_relative(rng):
    R, Tr, f, c = _rig(4)
    jc, tc = jcam.make_cameras(R, Tr, f, c), tcam.make_cameras(R, Tr, f, c)
    pts = rng.normal(size=(4, 7, 3)).astype(np.float32)
    close(tcam.camera_center(tc), jcam.camera_center(jc), CLOSED)
    close(tcam.transform_points_ndc(tc, T(pts)), jcam.transform_points_ndc(jc, jnp.asarray(pts)), CLOSED)
    close(tcam.transform_points_ndc(tc, T(pts[:1])), jcam.transform_points_ndc(jc, jnp.asarray(pts[:1])), CLOSED)
    close(tcam.unproject_points(tc, T(pts)), jcam.unproject_points(jc, jnp.asarray(pts)), CLOSED)
    jr, tr = jcam.relative_cameras(jc, jnp.asarray([2])), tcam.relative_cameras(tc, torch.tensor([2]))
    for a, b in zip(tr, jr):
        close(a, b, CLOSED)


def test_rays_harmonics_plucker(rng):
    R, Tr, f, c = _rig(3)
    jc, tc = jcam.make_cameras(R, Tr, f, c), tcam.make_cameras(R, Tr, f, c)
    jr, tr = jrays.pixel_rays(jc, 6, 5), trays.pixel_rays(tc, 6, 5)
    for a, b in zip(tr, jr):
        close(a, b, CLOSED)
    depth = rng.uniform(0.5, 2.5, size=(3, 6, 5, 2)).astype(np.float32)
    close(trays.rays_to_points(tr, T(depth)), jrays.rays_to_points(jr, jnp.asarray(depth)), CLOSED)
    o, d = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2))
    close(trays.plucker_coords(T(o), T(d)), jrays.plucker_coords(jnp.asarray(o), jnp.asarray(d)), CLOSED)
    x = rng.normal(size=(4, 6)).astype(np.float32) * 2
    close(tharm.harmonic_embed(T(x)), jharm.harmonic_embed(jnp.asarray(x)), CLOSED)


def test_grid_sample_matches(rng):
    feat = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    xy = rng.uniform(-1.3, 1.3, size=(2, 40, 2)).astype(np.float32)  # past the border clamp
    close(tgrid.grid_sample(T(feat), T(xy)), jgrid.grid_sample(jnp.asarray(feat), jnp.asarray(xy)), CLOSED)
    close(tgrid.grid_sample(T(feat), T(xy)), jgrid.grid_sample_mxu(jnp.asarray(feat), jnp.asarray(xy)), CLOSED)


def test_image_ops_match(rng):
    x = rng.uniform(size=(2, 16, 12, 3)).astype(np.float32)
    close(timg.area_downsample(T(x), 4), jimg.area_downsample(jnp.asarray(x), 4), CLOSED)
    close(timg.nearest_upsample2x(T(x)), jimg.nearest_upsample2x(jnp.asarray(x)), 0.0)
    close(timg.bicubic_resize(T(x), 22, 9), jimg.bicubic_resize(jnp.asarray(x), 22, 9), CLOSED)
    y = rng.normal(size=(3, 4)).astype(np.float32)
    close(tcommon.normalize(T(y)), jcommon.normalize(jnp.asarray(y)), 0.0)
    close(tcommon.unnormalize(T(y)), jcommon.unnormalize(jnp.asarray(y)), 0.0)


# ------------------------------------------------------------ building blocks
def test_timestep_embedding_matches():
    """cos/sin of arguments up to t=999 rad: one float32 ulp of such an
    argument is 6e-5, and the two libraries' exp() may differ by an ulp."""
    t = np.array([0, 1, 500, 999], np.int32)
    for dim in (32, 33, 320):
        close(tl.timestep_embedding(T(t), dim), jl.timestep_embedding(jnp.asarray(t), dim), 2e-4)


@pytest.mark.parametrize("act,eps", [("none", 1e-5), ("silu", 1e-6)])
def test_groupnorm32_matches(rng, act, eps):
    x = (rng.normal(size=(2, 4, 4, 64)) * 3 + 1).astype(np.float32)
    g, b = (1 + 0.1 * rng.normal(size=64)).astype(np.float32), (0.1 * rng.normal(size=64)).astype(np.float32)
    p = {"params": {"GroupNorm_0": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}}}
    ref = jl.GroupNorm32(epsilon=eps, act=act).apply(p, jnp.asarray(x))
    m = tl.GroupNorm32(64, eps=eps, act=act)
    m.load_state_dict({"weight": T(g), "bias": T(b)})
    close(m(T(x)).detach(), ref, MODULE)


def test_groupnorm32_concat_equals_reference_pieces(rng):
    """The port joins the up-path skip by concatenation; the reference
    normalises the two pieces without materialising the concat, with a
    group straddling the seam (20 + 44 channels, 2 per group). Same function."""
    a = rng.normal(size=(2, 4, 4, 20)).astype(np.float32)
    s = (rng.normal(size=(2, 4, 4, 44)) * 2).astype(np.float32)
    g, b = (1 + 0.1 * rng.normal(size=64)).astype(np.float32), (0.1 * rng.normal(size=64)).astype(np.float32)
    p = {"params": {"GroupNorm_0": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}}}
    ya, ys = jl.GroupNorm32(act="silu").apply(p, jnp.asarray(a), jnp.asarray(s))
    m = tl.GroupNorm32(64, act="silu")
    m.load_state_dict({"weight": T(g), "bias": T(b)})
    close(m(torch.cat([T(a), T(s)], -1)).detach(), np.concatenate([ya, ys], -1), MODULE)


def test_layernorm_fp32_matches(rng):
    x = (rng.normal(size=(3, 5, 48)) * 4 + 2).astype(np.float32)
    g, b = (1 + 0.1 * rng.normal(size=48)).astype(np.float32), (0.1 * rng.normal(size=48)).astype(np.float32)
    ref = jl.LayerNormFp32().apply({"params": {"LayerNorm_0": {"scale": g, "bias": b}}}, jnp.asarray(x))
    m = tl.LayerNormFp32(48)
    m.load_state_dict({"weight": T(g), "bias": T(b)})
    close(m(T(x)).detach(), ref, MODULE)
    ref = jl.LayerNormFp32(use_scale_bias=False, epsilon=1e-6).apply({"params": {}}, jnp.asarray(x))
    close(tl.LayerNormFp32(48, eps=1e-6, elementwise_affine=False)(T(x)), ref, MODULE)


def _dense(rng, i, o, bias=True):
    k = (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
    d = {"kernel": jnp.asarray(k)}
    sd = {"weight": T(k.T.copy())}
    if bias:
        b = (0.1 * rng.normal(size=o)).astype(np.float32)
        d["bias"] = jnp.asarray(b)
        sd["bias"] = T(b)
    return d, sd


def _load(module, sd):
    module.load_state_dict(sd)
    return module


def test_feedforward_geglu_matches(rng):
    (pg, sg), (po, so) = _dense(rng, 16, 128), _dense(rng, 64, 16)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    ref = jl.FeedForward(16).apply({"params": {"geglu": {"proj": pg}, "out": po}}, jnp.asarray(x))
    m = _load(tl.FeedForward(16), {"net.0.proj.weight": sg["weight"], "net.0.proj.bias": sg["bias"],
                                   "net.2.weight": so["weight"], "net.2.bias": so["bias"]})
    close(m(T(x)).detach(), ref, MODULE)


@pytest.mark.parametrize("ctx_len", [0, 1, 3])
def test_cross_attention_matches(rng, ctx_len):
    """Self-attention (ctx_len 0), the exact 1-key collapse, and 3 keys."""
    heads, dh, C, Cc = 2, 8, 16, 12
    p, sd = {}, {}
    for n, i in (("to_q", C), ("to_k", Cc if ctx_len else C), ("to_v", Cc if ctx_len else C)):
        p[n], s = _dense(rng, i, heads * dh, bias=False)
        sd[f"{n}.weight"] = s["weight"]
    p["to_out"], s = _dense(rng, heads * dh, C)
    sd.update({"to_out.0.weight": s["weight"], "to_out.0.bias": s["bias"]})
    x = rng.normal(size=(2, 6, C)).astype(np.float32)
    ctx = rng.normal(size=(2, ctx_len, Cc)).astype(np.float32) if ctx_len else None
    ref = jl.CrossAttention(heads, dh).apply({"params": p}, jnp.asarray(x), None if ctx is None else jnp.asarray(ctx))
    m = _load(tl.CrossAttention(C, heads, dh, Cc if ctx_len else None), sd)
    close(m(T(x), None if ctx is None else T(ctx)).detach(), ref, MODULE)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_conv1x1_bf16_rounds_as_flax_dense(rng, cin, cout):
    """Conv1x1 in bf16 (the UNet's skip, proj_in and proj_out; the VAE's 1x1
    layers) against flax's Dense(dtype=bf16), which rounds the product, then
    the bias add: 1 bf16 ulp of max|ref|, mean <= 1e-4 x max|ref|. Measured
    on the CPU: bit for bit; rounding once (product + bias) misses the mean at
    2.2-2.7e-4 x max|ref|."""
    w = rng.normal(size=(cin, cout)).astype(np.float32) * cin**-0.5
    bias = rng.normal(size=(cout,)).astype(np.float32)
    x = rng.normal(size=(2, 4, 4, cin)).astype(np.float32)
    w, bias, x = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (w, bias, x))
    ref = jnn.Dense(cout, dtype=jnp.bfloat16).apply({"params": {"kernel": w, "bias": bias}}, jnp.asarray(x))
    ref = np.asarray(ref.astype(jnp.float32))
    m = _load(tl.Conv1x1(cin, cout), {"weight": T(w.T[:, :, None, None].copy()), "bias": T(bias)}).to(torch.bfloat16)
    out = m(T(x).to(torch.bfloat16)).detach().float().numpy()
    scale = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= 2.0 ** (np.floor(np.log2(scale)) - 7), f"max|diff| {err.max():.3e}, max|ref| {scale:.3e}"
    assert err.mean() <= 1e-4 * scale, f"mean|diff| {err.mean():.3e}, max|ref| {scale:.3e}"


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 96)])
def test_linear_bf16_rounds_as_flax_dense(rng, cin, cout, bias):
    """Linear in bf16 (the time and label embeddings, the module-path sites'
    to_out and GEGLU proj, CLIP's projections and MLP) against flax's
    Dense(dtype=bf16), with and without bias: 1 bf16 ulp of max|ref|, mean
    <= 1e-4 x max|ref|, as the Conv1x1 test holds."""
    w = rng.normal(size=(cin, cout)).astype(np.float32) * cin**-0.5
    b = rng.normal(size=(cout,)).astype(np.float32)
    x = rng.normal(size=(2, 7, cin)).astype(np.float32)
    w, b, x = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (w, b, x))
    params = {"kernel": w, **({"bias": b} if bias else {})}
    ref = jnn.Dense(cout, use_bias=bias, dtype=jnp.bfloat16).apply({"params": params}, jnp.asarray(x))
    ref = np.asarray(ref.astype(jnp.float32))
    sd = {"weight": T(w.T.copy()), **({"bias": T(b)} if bias else {})}
    m = _load(tl.Linear(cin, cout, bias=bias), sd).to(torch.bfloat16)
    out = m(T(x).to(torch.bfloat16)).detach().float().numpy()
    scale = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= 2.0 ** (np.floor(np.log2(scale)) - 7), f"max|diff| {err.max():.3e}, max|ref| {scale:.3e}"
    assert err.mean() <= 1e-4 * scale, f"mean|diff| {err.mean():.3e}, max|ref| {scale:.3e}"


def test_timm_attention_and_mlp_match(rng):
    (pq, sq), (pp, sp) = _dense(rng, 16, 48), _dense(rng, 16, 16)
    x = rng.normal(size=(3, 8, 16)).astype(np.float32)
    ref = jl.TimmAttention(4).apply({"params": {"qkv": pq, "proj": pp}}, jnp.asarray(x))
    m = _load(tl.TimmAttention(16, 4), {"qkv.weight": sq["weight"], "qkv.bias": sq["bias"],
                                         "proj.weight": sp["weight"], "proj.bias": sp["bias"]})
    close(m(T(x)).detach(), ref, MODULE)
    (p1, s1), (p2, s2) = _dense(rng, 16, 32), _dense(rng, 32, 16)
    ref = jl.Mlp(32, 16).apply({"params": {"fc1": p1, "fc2": p2}}, jnp.asarray(x))
    m = _load(tl.Mlp(16, 32, 16), {"fc1.weight": s1["weight"], "fc1.bias": s1["bias"],
                                    "fc2.weight": s2["weight"], "fc2.bias": s2["bias"]})
    close(m(T(x)).detach(), ref, MODULE)


def test_upsample_conv_matches_phase_folded_reference(rng):
    """Nearest 2x + 3x3 conv (the port) equals the reference's phase-folded
    low-resolution form."""
    k = (rng.normal(size=(3, 3, 8, 6)) / 8).astype(np.float32)
    b = (0.1 * rng.normal(size=6)).astype(np.float32)
    x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    ref = jl.UpsampleConv(6).apply({"params": {"kernel": k, "bias": b}}, jnp.asarray(x))
    m = Upsample(8)
    m.conv = tl.Conv2d(8, 6, 3, padding=1)
    m.load_state_dict({"conv.weight": T(np.transpose(k, (3, 2, 0, 1)).copy()), "conv.bias": T(b)})
    close(m(T(x)).detach(), ref, MODULE)


# ------------------------------------------------------------- package hygiene
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("root", ["mvdfusion_tpu_torch", "chip_smoke.py"])
def test_port_imports_no_jax(root):
    files = [REPO / root] if root.endswith(".py") else sorted((REPO / root).rglob("*.py"))
    assert files
    if root == "mvdfusion_tpu_torch":  # every subpackage, the eval path's cli/, data/, utils/ included
        assert {"cli", "data", "utils", "ops", "nn", "pipeline"} <= {f.parent.name for f in files}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "mvdfusion_tpu"), f"{f}: imports {mod}"


def test_kernel_signatures_match_sources():
    """ctypes argument kinds in ops/_lib.py against the C entry points."""
    kinds = {"const void*": "p", "void*": "p", "int": "i", "int64_t": "l", "float": "f"}
    found = {}
    for f in sorted((REPO / "mvdfusion_tpu_torch" / "csrc").glob("*.cu")):
        for name, args in re.findall(r"MVDF_API int (\w+)\(([^)]*)\)", f.read_text()):
            found[name] = "".join(kinds[" ".join(a.split()[:-1])] for a in args.split(","))
    assert found == _lib._SIGNATURES
