"""The site GEMM's plain version and route, and the weights the card's kernels
read prepared once per parameter (ops/block.py::prepare_site_weights,
ops/crossview.py::prepare_crossview_weights), on the CPU at tiny widths.

On the card nn/unet.py's sites and GridAttn take their prepared weights from
a cache on their module (`_lib.reads_prepared` is true there); the tests
force that route on the CPU, where the plain versions then read the prepared
weights (GEGLU unpacked). Exact comparisons (torch.equal) throughout: the
prepared weights are the parameters cast, concatenated and reordered, and
the plain versions compute the same operations on the same values.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mvdfusion_tpu_torch.geometry.cameras import Cameras, look_at_view_transform
from mvdfusion_tpu_torch.nn import unet as U
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops import block as K3
from mvdfusion_tpu_torch.ops import crossview as K4
from mvdfusion_tpu_torch.ops.attention import attention_plain
from mvdfusion_tpu_torch.ops.groupnorm import group_norm_plain

BF = torch.bfloat16


def _rand(rng, *shape, std=1.0, dt=torch.float32):
    return torch.tensor((rng.normal(size=shape) * std).astype(np.float32)).to(dt)


def _site(rng, C, dt):
    lin = lambda o, i: _rand(rng, o, i, std=i**-0.5, dt=dt)
    vec = lambda n, base=0.0: base + _rand(rng, n, std=0.1)
    return K3.BlockWeights(
        gn_w=vec(C, 1.0), gn_b=vec(C), pi_w=lin(C, C), pi_b=vec(C), ln1_w=vec(C, 1.0), ln1_b=vec(C),
        qkv_w=lin(3 * C, C), out_w=lin(C, C), out_b=vec(C), ln3_w=vec(C, 1.0), ln3_b=vec(C),
        g_w=lin(8 * C, C), g_b=vec(8 * C), f_w=lin(C, 4 * C), f_b=vec(C), po_w=lin(C, C), po_b=vec(C))


def test_geglu_packing_is_undone_exactly():
    """pack_geglu puts 32 value rows then their 32 gate rows in each 64-row
    group; unpack_geglu restores [value; gate] bit for bit, and
    unprepared_site_weights gives back every field of the raw weights."""
    rng = np.random.default_rng(0)
    w = _site(rng, 32, BF)
    wp, bp = K3.pack_geglu(w.g_w, w.g_b)
    inner = w.g_w.shape[0] // 2
    assert torch.equal(wp[32:64], w.g_w[inner : inner + 32]) and torch.equal(bp[:32], w.g_b[:32])
    back = K3.unprepared_site_weights(K3.prepare_site_weights(w, BF))
    for f in K3.BlockWeights._fields:
        got, want = getattr(back, f), getattr(w, f)
        assert got.dtype == (BF if want.dtype == BF else torch.float32)
        assert torch.equal(got.float(), want.float()), f


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_gemm_plain_geglu_matches_site_math(dt):
    """gemm_plain's GEGLU over packed rows with `steps` is the site's plain
    GEGLU (_mm over [value; gate], then value * _gelu(gate)) bit for bit."""
    rng = np.random.default_rng(1)
    w = _site(rng, 32, dt)
    x = _rand(rng, 70, 32, dt=dt)
    g = K3._mm(x, w.g_w, w.g_b)
    want = g[:, :128] * K3._gelu(g[:, 128:])
    wp, bp = K3.pack_geglu(w.g_w, w.g_b)
    got = K3.gemm(x, wp, bp, act=K3.ACT_GEGLU, steps=True)  # CPU tensors: the plain version
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("a2_map", [False, True], ids=["row", "map"])
def test_k3_launcher_on_plain_kernels_matches_plain_site(monkeypatch, dt, a2_map):
    """K3's launcher, with its LayerNorm, K1 and K2 replaced by their plain
    versions and the GEMM taking its own (CPU tensors), on prepared weights:
    the same bits as transformer_block_plain on the raw weights, and every
    weight a GEMM reads is a field of the prepared weights itself (no cast,
    concatenation or packing on a forward)."""
    rng = np.random.default_rng(2)
    B, N, C, heads = 2, 64, 32, 4
    w = _site(rng, C, dt)
    x = _rand(rng, B, N, C, dt=dt)
    a2 = _rand(rng, *((B, N, C) if a2_map else (B, C)), dt=dt)
    prepared = K3.prepare_site_weights(w, dt)
    read = []
    gemm = K3.gemm
    monkeypatch.setattr(K3, "gemm", lambda a, wt, *r, **k: read.append(wt) or gemm(a, wt, *r, **k))
    monkeypatch.setattr(K3, "layernorm", lambda h, lw, lb: K3._ln_plain(h, lw, lb))
    monkeypatch.setattr(K3, "launch_group_norm", group_norm_plain)
    monkeypatch.setattr(K3, "launch_attention", lambda q, k, v, s, m: attention_plain(q, k, v, s, m).contiguous())
    got = K3.launch_transformer_block(x, a2, prepared, heads)
    assert torch.equal(got, K3.transformer_block_plain(x, a2, w, heads))
    fields = ("pi_w", "qkv_w", "out_w", "g_w", "f_w", "po_w")
    assert [id(t) for t in read] == [id(getattr(prepared, f)) for f in fields]


def test_gemm_route():
    """Every bf16 product of the main path takes the wgmma kernel; fp32 takes
    the CUDA-core tile; a bf16 shape the wgmma kernel does not take (an
    output width that is not a multiple of 4) goes to the wmma tile, counted
    under its own name."""
    for N, K, act in ((320, 320, 0), (960, 320, 0), (2560, 320, 2), (320, 1280, 0), (640, 640, 0), (1920, 640, 0),
                      (5120, 640, 2), (640, 2560, 0), (768, 256, 0), (256, 256, 0), (512, 256, 1), (256, 512, 0),
                      (1280, 1280, 0), (5120, 1280, 2), (1280, 5120, 0)):
        assert K3.gemm_route(BF, N, K, act) == "sm90", (N, K)
    assert K3.gemm_route(torch.float32, 320, 320) == "f32"
    assert K3.gemm_route(BF, 322, 320) == "wmma" and K3.gemm_route(BF, 256, 322) == "wmma"


def _tiny(dtype=torch.float32):
    cfg = dataclasses.replace(ViewFusionConfig().tiny(), dtype=dtype)
    return randomize_(ViewFusion(cfg, device="cpu"), seed=0).eval()


def _step(model, prepared: bool, monkeypatch):
    """One apply_model_cfg on fixed numpy inputs (3 target views), with the
    sites reading their prepared weights or the parameters as they are."""
    monkeypatch.setattr(_lib, "reads_prepared", lambda t: prepared)
    rng = np.random.default_rng(3)
    B, H = 3, model.cfg.latent_size
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, B + 1) + 90)
    cams = lambda s: Cameras(torch.tensor(R[s]), torch.tensor(T[s]), torch.full((len(R[s]), 2), 2.1875),
                             torch.zeros(len(R[s]), 2))
    r = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    with torch.no_grad():
        return model.apply_model_cfg(r(B, H, H, 5), cams(slice(1, None)), r(1, H, H, 5), cams(slice(0, 1)),
                                     r(B, 1, model.cfg.context_dim + 28), torch.full((B,), 500), 2.5,
                                     r(B, H, H, 1))


def _kernel_sites(model):
    return [m for m in model.unet.modules() if "_mvdf_site_weights" in m.__dict__]


def test_apply_model_cfg_prepared_matches_unprepared_bitwise(monkeypatch):
    """The tiny model's apply_model_cfg through prepared weights (the card's
    route: 5 split sites at 16^2 and GridAttn) equals the one through the
    parameters as they are, bit for bit."""
    model = _tiny()
    plain = _step(model, False, monkeypatch)
    assert not _kernel_sites(model)
    prepared = _step(model, True, monkeypatch)
    assert len(_kernel_sites(model)) == 5 and "_mvdf_crossview_weights" in model.view_attn.__dict__
    assert torch.equal(prepared, plain)


def test_prepared_cache_hits_on_second_forward(monkeypatch):
    """The second forward prepares nothing: the sites and GridAttn read what
    the first one kept on their modules."""
    model = _tiny()
    built = []
    prep_site, prep_cv = K3.prepare_site_weights, K4.prepare_crossview_weights
    monkeypatch.setattr(K3, "prepare_site_weights", lambda *a: built.append("site") or prep_site(*a))
    monkeypatch.setattr(K4, "prepare_crossview_weights", lambda *a: built.append("cv") or prep_cv(*a))
    first = _step(model, True, monkeypatch)
    kept = [m._mvdf_site_weights[1] for m in _kernel_sites(model)]
    assert sorted(built) == ["cv"] + ["site"] * 5
    built.clear()
    assert torch.equal(_step(model, True, monkeypatch), first)
    assert built == []
    assert all(m._mvdf_site_weights[1] is w for m, w in zip(_kernel_sites(model), kept))


def test_prepared_cache_rebuilt_after_update_and_cast():
    """A site's and GridAttn's prepared weights are rebuilt after an in-place
    update under torch.no_grad() (the parameter's version moves) and after
    cast_for_inference (its data and dtype move), and hold the new values."""
    model = _tiny(BF)
    site = next(m for m in model.unet.modules() if isinstance(m, U.SpatialTransformer))
    params = U._site_params(site.norm, site.proj_in, site.proj_out, site.transformer_blocks[0])
    prep = lambda dt: K3.prepared_site_weights(site, params, lambda: U._site_weights(params), dt)
    w1 = prep(torch.float32)
    assert prep(torch.float32) is w1
    before = w1.pi_w.clone()  # the prepared matrix may alias the parameter
    with torch.no_grad():
        site.proj_in.weight.mul_(2.0)
    w2 = prep(torch.float32)
    assert w2 is not w1 and torch.equal(w2.pi_w, 2 * before)
    model.cast_for_inference()
    w3 = prep(BF)
    assert w3 is not w2 and w3.pi_w.dtype == BF and w3.gn_w.dtype == torch.float32
    assert torch.equal(w3.pi_w, site.proj_in.weight.reshape(w3.pi_w.shape))
    va = model.view_attn
    with torch.no_grad():
        t0 = model.embed_time(torch.tensor([500]))[0]
    _, agg1 = va.kernel_weights(t0, prepared=True)
    _, agg2 = va.kernel_weights(t0, prepared=True)
    assert agg2.qkv_w[0] is agg1.qkv_w[0] and isinstance(agg1, K4.PreparedAggregator)
    with torch.no_grad():
        va.final_layer_b.bias.add_(1.0)
    _, agg3 = va.kernel_weights(t0, prepared=True)
    assert agg3.qkv_w[0] is not agg1.qkv_w[0] and torch.equal(agg3.fin_b, va.final_layer_b.bias.float())
