"""The port's evaluation path against the JAX package: the two-phase K4 form
and its route, the rigs and loaders, the config reader, the metrics, the
artifact writer, the chunked decode, the sampler's feed_prev_depth and the
whole eval chain; then the demo CLI and a CPU rehearsal of chip_smoke.py's
eval phase.

Inputs, weights and noise are numpy arrays from a seed fed to both packages,
fp32 on the CPU; the JAX side runs its Pallas kernels in interpret mode.
Tolerances, stated per test: 1e-4 max-abs for a module (sums in another
order), 1e-6 for the same float32 formula, 1e-5 for the float64 metrics
(their float32 inputs pass through two libraries' geometry), 1e-3 relative
for chains through the whole model (fp32 through ~60 layers).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mvdfusion_tpu.convert import mapping as jmap
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.core import config as jconfig
from mvdfusion_tpu.core.schedule import make_ddpm_schedule as jddpm
from mvdfusion_tpu.data import datasets as jdata
from mvdfusion_tpu.data import rigs as jrigs
from mvdfusion_tpu.geometry.cameras import Cameras as JCameras
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.geometry.cameras import make_cameras as jmake
from mvdfusion_tpu.nn.viewattn import GridAttn as JGridAttn
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu.ops import crossview as jcv
from mvdfusion_tpu.pipeline.sampler import ddim_sample as j_ddim_sample
from mvdfusion_tpu.utils import metrics as jmetrics
from mvdfusion_tpu.utils import vis as jvis
from mvdfusion_tpu_torch.core import config as tconfig
from mvdfusion_tpu_torch.core.schedule import make_ddpm_schedule
from mvdfusion_tpu_torch.data import datasets as tdata
from mvdfusion_tpu_torch.data import rigs as trigs
from mvdfusion_tpu_torch.geometry.cameras import Cameras, make_cameras
from mvdfusion_tpu_torch.nn.viewattn import GridAttn
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.ops import crossview as K4
from mvdfusion_tpu_torch.pipeline.eval import eval_scenes
from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample
from mvdfusion_tpu_torch.utils import metrics as tmetrics
from mvdfusion_tpu_torch.utils import vis as tvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [os.path.join(REPO, "configs", n) for n in ("gso.yaml", "wild.yaml", "colab.yaml")]


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= tol, f"max|diff| {err:.3e} > {tol:g}"


def rel_close(got, ref, tol=1e-3):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * max(scale, 1e-6), f"max|diff| {err:.3e} vs max|ref| {scale:.3e}"


def T(a):
    return torch.as_tensor(np.asarray(a))


def count_two_phase(monkeypatch):
    """Force the two-phase K4 form in both packages (the reference's
    maps-resident budget set to 0, as tests/test_ops_crossview.py does) and
    count the port's calls of its two-phase plain version."""
    monkeypatch.setattr(jcv, "_SINGLE_KERNEL_MAPS_BYTES", 0)
    monkeypatch.setattr(K4, "_SINGLE_KERNEL_MAPS_BYTES", 0)
    calls = []
    plain = K4.crossview_two_phase_plain
    monkeypatch.setattr(K4, "crossview_two_phase_plain", lambda *a: calls.append(1) or plain(*a))
    return calls


# ------------------------------------------------------------- (a)-(c) K4b
@dataclasses.dataclass(frozen=True)
class _ViewattnCfg:
    viewattn_layers: int = 2


def _gridattn_pair(V, H, D, dtype, hidden=32, heads=4, layers=2, out_dim=48):
    """The port's GridAttn (weights in `dtype`) and the JAX module's output
    on the same weights (cast to `dtype`, as cast_inference_params does) and
    inputs, both through the K4 form that the budget routes them to."""
    rng = np.random.default_rng(10 + V)
    m = randomize_(GridAttn(hidden_size=hidden, output_dim=out_dim, num_heads=heads,
                            num_layers=layers, n_pts_per_ray=D), seed=3)
    table = jmap.viewattn_mapping(_ViewattnCfg(layers))
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    tree = {}
    for fpath, (tkey, tf) in table.items():
        d = tree
        for p in fpath[:-1]:
            d = d.setdefault(p, {})
        d[fpath[-1]] = jnp.asarray(TRANSFORMS[tf](sd[tkey.lstrip(".")]).astype(np.float32)).astype(jdt)
    R, Tr = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 360 * (V - 1) / V, V) + 90)
    f, c = np.full((V, 2), 2.1875, np.float32), np.zeros((V, 2), np.float32)
    noisy = (rng.normal(size=(V, H, H, 5)) * 0.5).astype(np.float32)
    in_lat = (rng.normal(size=(1, H, H, 5)) * 0.5).astype(np.float32)
    t_embed = rng.normal(size=(V, hidden)).astype(np.float32)
    jitter = rng.normal(size=(V, H, H, D)).astype(np.float32)
    t = np.full((V,), 500, np.int32)
    jm = JGridAttn(hidden_size=hidden, output_dim=out_dim, num_heads=heads, num_layers=layers,
                   n_pts_per_ray=D, crossview_kernel="interpret", dtype=jdt)
    ref = jm.apply({"params": tree}, jnp.asarray(noisy), jmake(R, Tr, f, c), jnp.ones((V,)), jnp.asarray(t_embed),
                   jnp.asarray(t), jddpm(1000), jnp.asarray(in_lat), jmake(R[:1], Tr[:1], f[:1], c[:1]),
                   jax.random.PRNGKey(0), jitter_noise=jnp.asarray(jitter))
    m = m.to(dtype)
    with torch.no_grad():
        out = m(T(noisy), make_cameras(R, Tr, f, c), torch.ones(V), T(t_embed), T(t).long(), make_ddpm_schedule(),
                T(in_lat), make_cameras(R[:1], Tr[:1], f[:1], c[:1]), T(jitter))
    assert tuple(out.shape) == (V, H, H, D, out_dim)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


def bf16_ulp(x):
    """The bf16 ulp at |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


@pytest.mark.parametrize("V,H,D", [(3, 8, 1), (4, 8, 3)])
def test_k4_two_phase_gridattn_matches_pallas(monkeypatch, V, H, D):
    """(a) GridAttn through the two-phase form against the JAX module running
    _gather_kernel + _dit_kernel in interpret mode; shared jitter noise,
    fp32, tolerance 1e-4 max-abs."""
    calls = count_two_phase(monkeypatch)
    out, ref = _gridattn_pair(V, H, D, torch.float32)
    assert calls == [1]
    close(out, ref, 1e-4)


@pytest.mark.parametrize("V,H,D", [(3, 8, 1), (4, 8, 3)])
def test_k4_two_phase_gridattn_bf16_matches_pallas(monkeypatch, V, H, D):
    """(a) As above in bf16, the weights in bf16 on both sides, held to K4's
    own bounds: max|diff| <= 1 bf16 ulp of max|ref|, mean|diff| <= 1e-4 x
    max|ref|. The port's z_embedder rounds where the reference's Dense(dtype)
    and jax.nn.gelu round, op by op; measured on the CPU: 0.5 and 1 ulp,
    mean 6.6e-6 and 1.1e-5 x max|ref| (1 and 1.5 ulps, 6.4e-4 and 6.5e-4
    when the port rounded the product + bias and the GELU once each)."""
    calls = count_two_phase(monkeypatch)
    out, ref = _gridattn_pair(V, H, D, torch.bfloat16)
    assert calls == [1]
    scale = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= bf16_ulp(scale), f"max|diff| {err.max():.3e} vs bf16 ulp {bf16_ulp(scale):.3e}"
    assert err.mean() <= 1e-4 * scale, f"mean|diff| {err.mean():.3e} vs max|ref| {scale:.3e}"


@pytest.mark.slow
@pytest.mark.parametrize("V", [8, 15])
def test_gridattn_bf16_full_width_matches(V):
    """GridAttn at the model's width (hid 256, 8 heads, 3 layers, out 768,
    32^2, D=1) in bf16, each package on its own route (V=8 the single K4
    form, V=15 the two-phase one). Measured on the CPU: max|diff| 1 bf16 ulp
    of max|ref| for both V, mean|diff| 1.6e-4 (V=8) and 2.2e-4 (V=15) x
    max|ref|; before the z_embedder rounded as the reference does, 5.4e-4
    and 6.3e-4. At this width K4 alone, fed the same inputs, differs by
    1.0e-4 x max|ref| (fp32 sums in another order over 3 layers), and the
    fp32 geometry by up to 7.6e-6 in the reprojected xy. Held to 1 ulp and
    3e-4 x max|ref|, which the earlier rounding misses."""
    out, ref = _gridattn_pair(V, 32, 1, torch.bfloat16, hidden=256, heads=8, layers=3, out_dim=768)
    scale = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= bf16_ulp(scale), f"max|diff| {err.max():.3e} vs bf16 ulp {bf16_ulp(scale):.3e}"
    assert err.mean() <= 3e-4 * scale, f"mean|diff| {err.mean():.3e} vs max|ref| {scale:.3e}"


def _jax_k4_args(args):
    """The port's K4 operands as the JAX op's (in, out)-layout NamedTuples."""
    xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs = args

    def J(a):
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32)

    k = lambda ws: jnp.stack([J(x.t()) for x in ws])
    b = lambda bs: jnp.stack([J(x) for x in bs])
    jw = jcv.AggregatorWeights(
        qkv_k=k(w.qkv_w), qkv_b=b(w.qkv_b), proj_k=k(w.proj_w), proj_b=b(w.proj_b), fc1_k=k(w.fc1_w),
        fc1_b=b(w.fc1_b), fc2_k=k(w.fc2_w), fc2_b=b(w.fc2_b), mods=J(w.mods), wl_k=J(w.wl_w.t()), wl_b=J(w.wl_b),
        fin_k=J(w.fin_w.t()), fin_b=J(w.fin_b))
    jkg = jcv.GeoWeights(kall=J(kg.kall), kmask=J(kg.kmask)[None])
    return (J(xy), J(pts), J(centers), J(mask), J(b_acc), J(maps_p), jkg, jw, heads, 64, True, freqs)


@pytest.mark.parametrize("form", ["two_phase", "single"])
def test_k4_bf16_matches_pallas_form(monkeypatch, form):
    """(a) K4 alone in bf16 against the JAX op (interpret mode) in the same
    form, budget 0 forcing the two-phase one: both round the hat weights and
    the geometric features to bf16 before their products, and the two-phase
    form its tokens before b_acc. Measured on the CPU: max|diff| 0.5 bf16
    ulp of max|ref|, mean|diff| <= 1.9e-5 x max|ref| (1-2% of the outputs
    one rounding apart); held to 1 ulp and 1e-4 x max|ref|. The port's other
    form misses the second bound (measured 5e-4 x max|ref|), so the test
    sees the route and the rounding points."""
    if form == "two_phase":
        monkeypatch.setattr(jcv, "_SINGLE_KERNEL_MAPS_BYTES", 0)
    mine, other = ((K4.crossview_two_phase_plain, K4.crossview_plain) if form == "two_phase"
                   else (K4.crossview_plain, K4.crossview_two_phase_plain))
    args = _k4_args(np.random.default_rng(4), torch.bfloat16)
    ref = np.asarray(jcv.crossview_aggregate(*_jax_k4_args(args)).astype(jnp.float32))
    with torch.no_grad():
        out, out_other = mine(*args).float().numpy(), other(*args).float().numpy()
    scale = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= bf16_ulp(scale), f"max|diff| {err.max():.3e} vs bf16 ulp {bf16_ulp(scale):.3e}"
    assert err.mean() <= 1e-4 * scale, f"mean|diff| {err.mean():.3e} vs max|ref| {scale:.3e}"
    assert np.abs(out_other - ref).mean() > 1e-4 * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("V", [8, 12, 13, 15, 16])
def test_k4_route_matches_reference_byte_test(V, dtype):
    """(b) The port's route equals the reference's test
    V*H*W*hid*itemsize <= _SINGLE_KERNEL_MAPS_BYTES at 32^2, hid 256."""
    H = W = 32
    hid = 256
    item = jnp.dtype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32).itemsize
    ref = "single" if V * H * W * hid * item <= jcv._SINGLE_KERNEL_MAPS_BYTES else "two_phase"
    assert K4._SINGLE_KERNEL_MAPS_BYTES == jcv._SINGLE_KERNEL_MAPS_BYTES
    assert K4.crossview_route(V, H, W, hid, dtype) == ref
    fixed = {(8, torch.bfloat16): "single", (12, torch.bfloat16): "single", (13, torch.bfloat16): "two_phase",
             (8, torch.float32): "two_phase"}
    if (V, dtype) in fixed:
        assert ref == fixed[(V, dtype)]


def _k4_args(rng, dt, V=4, Hh=8, hid=64, L=2, heads=4, out_dim=48, nh=7):
    N, mlp, G = V * Hh * Hh, 2 * hid, 7 * (1 + 2 * nh)
    r = lambda *s, std=1.0, d=torch.float32: T((rng.normal(size=s) * std).astype(np.float32)).to(d)
    lin = lambda o, i: r(o, i, std=i**-0.5, d=dt)
    bias = lambda n: r(n, std=0.1, d=dt)  # in dt, as the model holds them after cast_for_inference
    w = K4.AggregatorWeights(
        qkv_w=[lin(3 * hid, hid) for _ in range(L)], qkv_b=[bias(3 * hid) for _ in range(L)],
        proj_w=[lin(hid, hid) for _ in range(L)], proj_b=[bias(hid) for _ in range(L)],
        fc1_w=[lin(mlp, hid) for _ in range(L)], fc1_b=[bias(mlp) for _ in range(L)],
        fc2_w=[lin(hid, mlp) for _ in range(L)], fc2_b=[bias(hid) for _ in range(L)],
        mods=r(L, 6, hid, std=0.5), wl_w=lin(1, hid), wl_b=bias(1), fin_w=lin(out_dim, hid),
        fin_b=bias(out_dim))
    kg = K4.GeoWeights(kall=r(G, hid, std=G**-0.5, d=dt), kmask=r(hid, std=0.1))
    return (r(V, N, 2, std=0.6), r(N, 3), r(V, 3, std=2.0), torch.ones(V), r(N, hid, d=dt),
            r(V, Hh, Hh, hid, d=dt), kg, w, heads, tuple(0.1 * 2.0**i for i in range(nh)))


def test_k4_two_phase_bf16_round_trip():
    """(c) In bf16 the two-phase plain version is the single form with the
    phase-1 tokens rounded to bf16 before b_acc (1e-6: the same operations),
    and it differs measurably from the single form (> 1e-3 x max|out|), so the
    route changes the function."""
    args = _k4_args(np.random.default_rng(4), torch.bfloat16)
    xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs = args
    with torch.no_grad():
        two = K4.crossview_two_phase_plain(*args).float()
        tok = K4.gather_tokens_plain(xy, pts, centers, mask, maps_p, kg, freqs).to(torch.bfloat16).float()
        x = torch.nn.functional.gelu(tok.transpose(0, 1) + b_acc.float()[:, None, :])
        by_hand = K4._dit_pool_plain(x, w, heads, torch.bfloat16).float()
        single = K4.crossview_plain(*args).float()
    close(two, by_hand, 1e-6)
    diff, scale = (two - single).abs().max().item(), single.abs().max().item()
    assert diff > 1e-3 * scale, f"two-phase vs single form: {diff:.3e} (max|out| {scale:.3e})"
    # in fp32 the round trip is the identity
    args32 = _k4_args(np.random.default_rng(4), torch.float32)
    with torch.no_grad():
        close(K4.crossview_two_phase_plain(*args32), K4.crossview_plain(*args32), 1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_gather_tokens_bound_covers_fp32_sums(dtype):
    """gather_tokens_bound, the allowance of the phase-1 token checks on the
    card, bounds two fp32 evaluations' difference: here the plain version's
    own error against a float64 sum of the same dt-rounded operands is
    within half of it (one of the two sides), with no rounding flips."""
    from mvdfusion_tpu_torch.geometry.gridsample import bilinear_taps

    xy, pts, centers, mask, _, maps_p, kg, _, _, freqs = _k4_args(np.random.default_rng(6), dtype)
    V, H, W, hid = maps_p.shape
    with torch.no_grad():
        tok = K4.gather_tokens_plain(xy, pts, centers, mask, maps_p, kg, freqs).double()
        idx, wt = bilinear_taps(xy, H, W)
        taps = maps_p.reshape(V, H * W, hid).double()[torch.arange(V)[:, None, None], idx]  # (V, N, 4, hid)
        tok64 = ((taps * wt.to(dtype).double()[..., None]).sum(2)
                 + K4.geo_aug(pts, centers, freqs).to(dtype).double() @ kg.kall.to(dtype).double()
                 + mask.double()[:, None, None] * kg.kmask.double())
        bound = K4.gather_tokens_bound(xy, pts, centers, mask, maps_p, kg, freqs, flips=0).double()
        flips = K4.gather_tokens_bound(xy, pts, centers, mask, maps_p, kg, freqs).double() - bound
    assert ((tok - tok64).abs() <= bound / 2).all(), ((tok - tok64).abs() / bound).max().item()
    assert (flips > 0).all() if dtype == torch.bfloat16 else (flips == 0).all()


# ------------------------------------------------------------ (d) loaders
@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    """A 2-scene GSO layout and a Wild directory of 80px RGBA pngs, some
    pixels with alpha < 0.5 (composited on white)."""
    root = tmp_path_factory.mktemp("eval_data")
    rng = np.random.default_rng(0)

    def rgba():
        a = (rng.uniform(size=(80, 80, 4)) * 255).astype(np.uint8)
        a[..., 3] = np.where(rng.uniform(size=(80, 80)) < 0.3, 40, 255)
        return Image.fromarray(a, "RGBA")

    gso = root / "gso"
    for s in range(2):
        (gso / f"scene_{s}").mkdir(parents=True)
        for i in range(16):
            rgba().save(gso / f"scene_{s}" / f"{i:03d}.png")
    (gso / "test.json").write_text(json.dumps(["scene_0", "scene_1"]))
    wild = root / "wild"
    wild.mkdir()
    for name in ("b.png", "a.png"):
        rgba().save(wild / name)
    return str(gso), str(wild)


def test_rigs_match():
    """(d) The fixed rigs, port against JAX, 1e-6."""
    for az, el in ((trigs.AZIMUTHS_16, trigs.ELEVATIONS_16), (trigs.AZIMUTHS_B64, trigs.ELEVATIONS_B64)):
        for a, b in zip(trigs.fixed_rig(az, el), jrigs.fixed_rig(az, el)):
            close(a, b, 1e-6)
    close(trigs.AZIMUTHS_B64, jrigs.AZIMUTHS_B64, 0)
    close(trigs.ELEVATIONS_B64, jrigs.ELEVATIONS_B64, 0)
    close(trigs.OBJAVERSE_TRAIN_RING, jrigs.OBJAVERSE_TRAIN_RING, 0)


@pytest.mark.parametrize("size", [64, 80])
def test_gso_and_wild_loaders_match(scene_dirs, monkeypatch, size):
    """(d) GSO and Wild scenes, with (64) and without (80) a resize, decoded
    through the same imageio/PIL path on both sides (both packages' C++
    decoders switched off): images equal to 1e-6, rigs to 1e-6."""
    monkeypatch.setattr(jdata, "_native_batch", lambda *a, **k: None)
    monkeypatch.setattr(tdata, "_native_batch", lambda *a, **k: None)
    gso, wild = scene_dirs
    for tcls, jcls, root in ((tdata.GSO, jdata.GSO, gso), (tdata.Wild, jdata.Wild, wild)):
        tds, jds = tcls(root, subset="test", image_size=size), jcls(root, subset="test", image_size=size)
        assert len(tds) == len(jds) == 2 and tds.n_views == jds.n_views == 16
        for i in range(2):
            a, b = tds[i], jds[i]
            assert a.keys() == b.keys() and a["idx"] == b["idx"] and a["index"] == b["index"]
            assert a["images"].shape == (16, size, size, 3)
            for k in ("images", "R", "T", "f", "c", "azimuth", "elevation"):
                close(a[k], b[k], 1e-6)


# ------------------------------------------------------------- (e) config
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_build_model_config_matches(path):
    """(e) Every field of the port's config equals the JAX one's, and the
    shipped configs give the defaults (the config chip_smoke.py uses)."""
    cfg = tconfig.build_model_config(tconfig.load_yaml(path))
    jcfg = jconfig.build_model_config(jconfig.load_yaml(path))
    for field in dataclasses.fields(cfg):
        got, ref = getattr(cfg, field.name), getattr(jcfg, field.name)
        if field.name == "dtype":
            assert str(got).removeprefix("torch.") == jnp.dtype(ref).name
        else:
            assert got == ref, (field.name, got, ref)
    # drop_conditions, a training key, is true in every shipped config and false by default (as in JAX)
    assert dataclasses.replace(cfg, drop_conditions=False) == ViewFusionConfig() and cfg.drop_conditions


def test_build_model_config_refuses_what_is_not_ported(scene_dirs):
    raw = tconfig.load_yaml(CONFIGS[0])
    raw["model"]["params"]["view_attn_config"]["params"]["keep_top_k_views"] = True
    assert tconfig.build_model_config(raw).keep_top_k_views  # ported: GridAttn's general path
    raw["model"]["params"]["embed_camera_pose"] = False
    # ported: the legacy zero123 pose path, read as the JAX package reads it
    assert not tconfig.build_model_config(raw).embed_camera_pose
    assert not jconfig.build_model_config(raw).embed_camera_pose
    gso, _ = scene_dirs
    ds = tconfig.build_dataset({"dataset": {"target": "dataset.gso_test.GSO", "params": {"root": gso}}})
    assert isinstance(ds, tdata.GSO)
    # ported: the Objaverse loader (tests/test_torch_port_data.py); a GSO root has no subset list
    assert tconfig._dataset_registry()["objaverse"] is tdata.Objaverse
    with pytest.raises(FileNotFoundError, match="subset_list"):
        tconfig.build_dataset({"dataset": {"target": "objaverse", "params": {"root": gso}}})


# ------------------------------------------------------------ (f) metrics
def test_metrics_match():
    """(f) PSNR, SSIM, the perceptual distance and the cross-view
    consistency on random RGB-D at 32^2 over the 16-view rig, 1e-5."""
    rng = np.random.default_rng(6)
    B, h = 16, 32
    a = rng.uniform(size=(B, h, h, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    close(tmetrics.psnr(a, b), jmetrics.psnr(a, b), 1e-5)
    close(tmetrics.ssim(a, b), jmetrics.ssim(a, b), 1e-5)
    close(tmetrics.perceptual_distance(a, b), jmetrics.perceptual_distance(a, b), 1e-5)
    # a smooth foreground blob on a far background, so every class is populated
    yy, xx = np.mgrid[-1:1:h * 1j, -1:1:h * 1j]
    blob = 0.35 + 0.1 * (xx**2 + yy**2) + 0.02 * rng.normal(size=(B, h, h))
    depth = np.where(xx**2 + yy**2 < 0.5, blob, 1.0)[..., None].astype(np.float32)
    R, Tr, f, c = jrigs.fixed_rig(jrigs.AZIMUTHS_16, jrigs.ELEVATIONS_16)
    got = tmetrics.cross_view_consistency(a, depth, R, Tr, f, c)
    ref = jmetrics.cross_view_consistency(a, depth, R, Tr, f, c)
    assert got.keys() == ref.keys() and got["n_pairs"] == ref["n_pairs"] == B * (B - 1)
    assert 0 < ref["depth_agree_rate"] < 1 and ref["covis_frac"] > 0
    for k in ("photo_mae", "depth_agree_rate", "covis_frac"):
        close(got[k], ref[k], 1e-5)
    m = tmetrics.AverageMeter(length=2)
    for v in (1.0, 2.0, 4.0):
        m.update(v)
    assert m.avg == 3.0


def test_split_list_matches():
    """The per-rank split of a scene list equals the reference's, exactly."""
    from mvdfusion_tpu.utils.common import split_list as jsplit
    from mvdfusion_tpu_torch.utils.common import split_list

    for n_items in (0, 1, 7, 30):
        for n in (1, 3, 8):
            assert split_list(list(range(n_items)), n) == jsplit(list(range(n_items)), n)


# ----------------------------------------------------------- (g) artifacts
def test_save_eval_artifacts_match(tmp_path):
    """(g) The same file names as the reference, with equal decoded pixels
    (every gif frame) and equal depth arrays."""
    rng = np.random.default_rng(7)
    B, H, h = 3, 32, 8
    pred, gt = (rng.uniform(size=(B, H, H, 3)).astype(np.float32) for _ in range(2))
    pd, idp, gd = rng.uniform(size=(B, h, h, 1)), rng.uniform(size=(1, h, h, 1)), rng.uniform(size=(B, h, h, 1))
    a, b = tmp_path / "port", tmp_path / "jax"
    ja = tvis.save_eval_artifacts(str(a), 0, 5, pred, gt, pred_depth=pd, input_depth=idp, gt_depth=gd)
    jb = jvis.save_eval_artifacts(str(b), 0, 5, pred, gt, pred_depth=pd, input_depth=idp, gt_depth=gd)
    assert os.path.basename(ja) == os.path.basename(jb)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) == 5
    for n in names:
        if n.endswith(".npy"):
            close(np.load(a / n), np.load(b / n), 0)
            continue
        ia, ib = Image.open(a / n), Image.open(b / n)
        assert getattr(ia, "n_frames", 1) == getattr(ib, "n_frames", 1)
        for k in range(getattr(ia, "n_frames", 1)):
            ia.seek(k)
            ib.seek(k)
            assert np.array_equal(np.asarray(ia.convert("RGB")), np.asarray(ib.convert("RGB"))), (n, k)


# ------------------------------------------------- (h)-(j) the whole model
S, IMG, STEPS = 4, 64, 4  # views, 64^2 images -> 16^2 latents with the tiny VAE, DDIM steps


@pytest.fixture(scope="module")
def pair():
    """The port model and the JAX ViewFusion on one random state dict, tiny
    config with feed_prev_depth on, two-phase K4 form forced on both sides
    for the module's tests."""
    mp = pytest.MonkeyPatch()
    calls = count_two_phase(mp)
    cfg = dataclasses.replace(ViewFusionConfig().tiny(), feed_prev_depth=True)
    jcfg = dataclasses.replace(JConfig().tiny(), fuse_mode="interpret", feed_prev_depth=True)
    model = randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = {}
    for fp, (tk, tf) in viewfusion_mapping(jcfg).items():
        d = tree
        *head, last = fp
        for p in head:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(TRANSFORMS[tf](sd[tk]).astype(np.float32))
    rng = np.random.default_rng(8)
    R, Tr = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    H = cfg.latent_size
    B = S - 1
    yield dict(
        cfg=cfg, model=model, jm=JViewFusion(jcfg), params={"params": tree}, calls=calls,
        scene=dict(images=rng.uniform(size=(S, IMG, IMG, 3)).astype(np.float32), R=R, T=Tr,
                   f=np.full((S, 2), 2.1875, np.float32), c=np.zeros((S, 2), np.float32)),
        input_idx=np.array([0]), target_idx=np.arange(1, S),
        init=rng.normal(size=(B, H, H, 5)).astype(np.float32),
        step_noise=rng.normal(size=(STEPS, B, H, H, 5)).astype(np.float32),
        jitter=rng.normal(size=(STEPS, B, H, H, 1)).astype(np.float32),
    )
    mp.undo()


def _j_sample(p, cams, in_lat, in_cams, clip_v):
    return j_ddim_sample(p["params"], p["jm"], cams, in_lat, in_cams, clip_v, jax.random.PRNGKey(0),
                         jnp.asarray(2.5), num_steps=STEPS, feed_prev_depth=True, return_trajectory=True,
                         init_noise=jnp.asarray(p["init"]), step_noise=jnp.asarray(p["step_noise"]),
                         jitter_noise=jnp.asarray(p["jitter"]))


def test_decode_latents_chunked_matches(pair):
    """(h) B=3 latents in chunks of 2 (one short chunk), 1e-3 relative."""
    z = np.random.default_rng(9).normal(size=(3, 16, 16, 4)).astype(np.float32)
    ref = jax.jit(lambda q, a: pair["jm"].apply(q, a, 2, method=JViewFusion.decode_latents_chunked))(
        pair["params"], jnp.asarray(z))
    with torch.no_grad():
        out = pair["model"].decode_latents_chunked(T(z), max_batch=2)
    assert tuple(out.shape) == (3, IMG, IMG, 3)
    rel_close(out, ref)


def test_feed_prev_depth_trajectory_matches(pair):
    """(i) Four eta=1 DDIM steps at CFG 2.5 with feed_prev_depth, init, step
    and jitter noise shared: every pred_x0 and the final latents, 1e-3
    relative."""
    p = pair
    sc = p["scene"]
    B = S - 1
    rng = np.random.default_rng(11)
    H = p["cfg"].latent_size
    cams = (sc["R"][1:], sc["T"][1:], sc["f"][1:], sc["c"][1:])
    in_cams = (sc["R"][:1], sc["T"][:1], sc["f"][:1], sc["c"][:1])
    in_lat = rng.normal(size=(1, H, H, 5)).astype(np.float32)
    clip_v = rng.normal(size=(B, 1, p["cfg"].context_dim + 28)).astype(np.float32)
    jc = lambda a: JCameras(*(jnp.asarray(x, jnp.float32) for x in a))
    tc = lambda a: Cameras(*(T(np.asarray(x, np.float32)) for x in a))
    ref = _j_sample(p, jc(cams), jnp.asarray(in_lat), jc(in_cams), jnp.asarray(clip_v))
    n0 = len(p["calls"])
    res = ddim_sample(p["model"], tc(cams), T(in_lat), tc(in_cams), T(clip_v), 2.5, num_steps=STEPS,
                      feed_prev_depth=True, return_trajectory=True, init_noise=T(p["init"]),
                      step_noise=T(p["step_noise"]), jitter_noise=T(p["jitter"]))
    assert len(p["calls"]) - n0 == STEPS
    rel_close(res.pred_x0_trajectory, ref.pred_x0_trajectory)
    rel_close(res.latents, ref.latents)


def test_eval_chain_matches(pair):
    """(j) The whole eval chain, 1 input + 3 targets: prepare_batch -> DDIM
    (feed_prev_depth, shared noise) -> chunked decode of the prediction and
    of the ground-truth latents -> unnormalised depths, against the same
    chain through the JAX package; every EvalOutput field 1e-3 relative."""
    p = pair
    sc = p["scene"]
    jm, params = p["jm"], p["params"]
    args = [jnp.asarray(sc[k]) for k in ("images", "R", "T", "f", "c")]
    prep = jax.jit(lambda q, *a: jm.apply(q, *a, method=JViewFusion.prepare_batch))
    bl, cams, in_lat, in_cams, clip_v = prep(params, *args, jnp.asarray(p["input_idx"]),
                                             jnp.asarray(p["target_idx"]))
    res = _j_sample(p, cams, in_lat, in_cams, clip_v)
    decode = jax.jit(lambda q, z: jm.apply(q, z, method=JViewFusion.decode_latents_chunked))
    unnorm = lambda d: np.clip((np.asarray(d) + 1) / 2, 0, 1)
    ref = dict(pred_rgb=decode(params, res.latents[..., :4]), gt_rgb=decode(params, bl[..., :4]),
               pred_depth=unnorm(res.latents[..., 4:]), gt_depth=unnorm(bl[..., 4:]),
               input_depth=unnorm(in_lat[..., 4:]))
    n0 = len(p["calls"])
    out = eval_scenes(p["model"], *(T(sc[k])[None] for k in ("images", "R", "T", "f", "c")),
                      T(p["input_idx"]), T(p["target_idx"]), 2.5, num_steps=STEPS,
                      init_noise=T(p["init"])[None], step_noise=T(p["step_noise"])[None],
                      jitter_noise=T(p["jitter"])[None])
    assert len(p["calls"]) - n0 == STEPS
    for k, v in ref.items():
        got = getattr(out, k)
        assert got.shape[0] == 1, k
        rel_close(got[0], v)


def _second_scene(p):
    """Another scene for the pair's model (other images, the rig turned by
    20 degrees, its own noise)."""
    rng = np.random.default_rng(12)
    R, Tr = look_at_view_transform(dist=1.5, elev=25.0, azim=np.linspace(0, 315, S) + 110)
    H, B = p["cfg"].latent_size, S - 1
    scene = dict(images=rng.uniform(size=(S, IMG, IMG, 3)).astype(np.float32), R=R, T=Tr,
                 f=np.full((S, 2), 2.1875, np.float32), c=np.zeros((S, 2), np.float32))
    noise = dict(init=rng.normal(size=(B, H, H, 5)).astype(np.float32),
                 step_noise=rng.normal(size=(STEPS, B, H, H, 5)).astype(np.float32),
                 jitter=rng.normal(size=(STEPS, B, H, H, 1)).astype(np.float32))
    return scene, noise


def _j_chain(p, sc, noise):
    """The JAX eval chain of one scene on the given noise."""
    jm, params = p["jm"], p["params"]
    args = [jnp.asarray(sc[k]) for k in ("images", "R", "T", "f", "c")]
    bl, cams, in_lat, in_cams, clip_v = jax.jit(lambda q, *a: jm.apply(q, *a, method=JViewFusion.prepare_batch))(
        params, *args, jnp.asarray(p["input_idx"]), jnp.asarray(p["target_idx"]))
    res = j_ddim_sample(params, jm, cams, in_lat, in_cams, clip_v, jax.random.PRNGKey(0), jnp.asarray(2.5),
                        num_steps=STEPS, feed_prev_depth=True, init_noise=jnp.asarray(noise["init"]),
                        step_noise=jnp.asarray(noise["step_noise"]), jitter_noise=jnp.asarray(noise["jitter"]))
    decode = jax.jit(lambda q, z: jm.apply(q, z, method=JViewFusion.decode_latents_chunked))
    unnorm = lambda d: np.clip((np.asarray(d) + 1) / 2, 0, 1)
    return dict(pred_rgb=decode(params, res.latents[..., :4]), gt_rgb=decode(params, bl[..., :4]),
                pred_depth=unnorm(res.latents[..., 4:]), gt_depth=unnorm(bl[..., 4:]),
                input_depth=unnorm(in_lat[..., 4:]))


def test_eval_chain_two_scenes_matches(pair):
    """The eval chain on two scenes in one sampler pass (N = 2: one UNet call
    a step over both scenes' CFG batch), against the JAX chain of each scene
    on its own noise, every EvalOutput field 1e-3 relative; and against the
    port's two one-scene calls, 1e-3 relative too: the UNet's CPU sums run
    in another order at batch 4B than at 2B (measured: 5.0e-5 at most, on
    pred_depth; the ground truth bit-equal), where a scene reading its batch
    mate's conditioning would differ by O(1)."""
    p = pair
    sc2, noise2 = _second_scene(p)
    scenes = [p["scene"], sc2]
    noises = [dict(init=p["init"], step_noise=p["step_noise"], jitter=p["jitter"]), noise2]
    stack = lambda key: torch.stack([T(n[key]) for n in noises])
    args = [torch.stack([T(np.asarray(sc[k], np.float32)) for sc in scenes]) for k in ("images", "R", "T", "f", "c")]
    n0 = len(p["calls"])
    timings = []
    out = eval_scenes(p["model"], *args, T(p["input_idx"]), T(p["target_idx"]), 2.5, num_steps=STEPS,
                      init_noise=stack("init"), step_noise=stack("step_noise"), jitter_noise=stack("jitter"),
                      timings=timings)
    assert len(p["calls"]) - n0 == 2 * STEPS and len(timings) == 1  # GridAttn a scene a step; one entry a call
    alone = [eval_scenes(p["model"], *(a[n : n + 1] for a in args), T(p["input_idx"]), T(p["target_idx"]), 2.5,
                         num_steps=STEPS, init_noise=stack("init")[n : n + 1],
                         step_noise=stack("step_noise")[n : n + 1], jitter_noise=stack("jitter")[n : n + 1])
             for n in range(2)]
    for n, (sc, noise) in enumerate(zip(scenes, noises)):
        ref = _j_chain(p, sc, noise)
        for k, v in ref.items():
            got = getattr(out, k)
            assert got.shape[0] == 2, k
            rel_close(got[n], v)
            rel_close(got[n], getattr(alone[n], k)[0])


# ---------------------------------------------------------- (k), (l) drives
def test_demo_cli_writes_artifacts_and_metrics(scene_dirs, tmp_path):
    """(k) The port's demo CLI on a fake GSO dir at the tiny config on the
    CPU: the reference's artifacts, and metrics.json with its six summary
    keys (mvdfusion_tpu/cli/demo.py:251-262), all finite."""
    from mvdfusion_tpu_torch.cli.demo import main

    gso, _ = scene_dirs
    exp = tmp_path / "demo_out"
    text = open(CONFIGS[0]).read()
    for a, b in (("root: demo_datasets/gso_eval/", f"root: {gso}/"), ("subset: test_syncdreamer", "subset: test"),
                 ("image_size: 256", "image_size: 64"), ("exp_dir: demo/", f"exp_dir: {exp}/"),
                 ("ckpt_path: weights/mvdfusion_tpu.ckpt", f"ckpt_path: {tmp_path}/absent.ckpt")):
        assert a in text
        text = text.replace(a, b)
    cfgp = tmp_path / "gso.yaml"
    cfgp.write_text(text)
    main(["-c", str(cfgp), "--tiny", "--device", "cpu", "--steps", "2", "--eval-num", "1"])
    vis = exp / "vis_gso_eval"
    files = sorted(os.listdir(vis))
    stem = "0000000_eval_000_n15"
    assert files == sorted([f"{stem}.jpg", f"{stem}.gif", f"{stem}_depth.png", f"{stem}_depth.npy",
                            f"{stem}_depth.gif", "metrics.json"]), files
    metrics = json.loads((vis / "metrics.json").read_text())
    keys = ("psnr", "ssim", "perceptual", "photo_mae", "depth_agree_rate", "covis_frac")
    assert set(metrics["summary"]) == set(keys) and len(metrics["scenes"]) == 1
    assert all(np.isfinite(metrics["summary"][k]) and np.isfinite(metrics["scenes"][0][k]) for k in keys)
    # tensor and view parallelism are ported (tests/test_torch_port_tp*.py): the train CLI takes --tp and
    # make_mesh lays out sp; a layout larger than its ranks raises rather than degrades
    from mvdfusion_tpu_torch.cli import train as train_cli
    from mvdfusion_tpu_torch.parallel import make_mesh
    from mvdfusion_tpu_torch.parallel.mesh import mesh_coords

    assert train_cli.parse_args(["-c", str(cfgp), "--tp", "2"]).tp == 2
    mesh = make_mesh(sp=2, world=2)
    assert (mesh.dp, mesh.sp, mesh.tp) == (1, 2, 1) and mesh_coords(1, mesh.dp, mesh.sp, mesh.tp) == (0, 1, 0)
    with pytest.raises(ValueError, match="needs more than"):
        make_mesh(sp=2, tp=2, world=2)
    # an existing ckpt_path is restored, not skipped: a file that is not a
    # checkpoint of the port's trainer fails in torch.load
    ckpt = tmp_path / "absent.ckpt"
    ckpt.write_text("")
    with pytest.raises(RuntimeError, match="absent.ckpt"):
        main(["-c", str(cfgp), "--tiny", "--device", "cpu"])


def test_chip_smoke_eval_rehearsal_on_cpu():
    """(l) chip_smoke.py's eval phase at the tiny config on the CPU: the same
    control flow and checks as on the card, minus the launch counts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.run_eval(2, "cpu", device="cpu", cfg=ViewFusionConfig().tiny()) == {}
