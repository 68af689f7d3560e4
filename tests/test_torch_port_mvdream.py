"""MVDream on the port (nn/mvdream.py, nn/unet.py's options, nn/clip.py's
text tower, pipeline/sampler.py::ddim_sample_views) against the plain
float32 replica tests/mvdream_ref.py, on the CPU at MVDreamConfig().tiny()
in float32 on seeded random weights: the UNet with 4 views joined in attn1
(and the same program with attn1 per view, which must miss), the causal
text tower, the camera rig, the VAE decode, a CFG sample; the spans a pass
records; and the layouts (MVDream's state-dict names at the published
sizes, MVD-Fusion's default UNet unchanged). This file imports no JAX.

Tolerances: both sides compute in float32 on the CPU, so they part only by
the order of sums (blocked GEMMs and convolutions, the fused softmax
against an explicit one): a few float32 ulps a product, ~1e-6 relative
through a tower. TOL, 1e-4 of the reference's largest magnitude, leaves
two orders of room above that and holds every output here.
"""

import copy
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import mvdream_ref as ref_mod
from mvdfusion_tpu_torch.core.config import MVDreamConfig
from mvdfusion_tpu_torch.nn.mvdream import MVDream, get_camera
from mvdfusion_tpu_torch.nn.unet import BasicTransformerBlock, UNetModel
from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample_views
from mvdfusion_tpu_torch.utils import trace

TOL = 1e-4  # of the reference's largest magnitude (module docstring)
N, STEPS, CFG_SCALE = 2, 4, 10.0
# sha256 of MVD-Fusion's default UNetModel() state-dict keys and shapes in
# order, as the parent of the MVDream options built them
MVDF_UNET_LAYOUT = "4b91fffb8bb5dc0b69d6d107cd479f9b25b88727b9c1f0aee3ee6d457ac5f53d"
MVDF_UNET_PARAMS = 1033789125


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_(model, seed):
    """portbench/weights.py's draw: norm scales 1 + N(0, 0.1^2), matrices
    N(0, 1 / fan_in), the rest (biases, embeddings) N(0, 0.02^2)."""
    g = torch.Generator().manual_seed(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if id(p) in norms:
                p.copy_(1.0 + 0.1 * r)
            elif p.ndim >= 2 and "embedding" not in name:
                p.copy_(r / p[0].numel() ** 0.5)
            else:
                p.copy_(0.02 * r)
    return model


@pytest.fixture(scope="module")
def pair():
    """(the port's tiny MVDream, the reference on the same weights)."""
    cfg = MVDreamConfig().tiny()
    ref = seeded_(ref_mod.MVDream(dataclasses.asdict(cfg)), 5).eval()
    model = MVDream(cfg, device="cpu")
    model.load_state_dict(ref.state_dict(), strict=True)
    return model.cast_for_inference().eval(), ref


def tokens(n, seed, length=77):
    """n prompts: BOS, 3-20 ids, EOS, zeros (portbench's draw, tiny vocab)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, length), np.int64)
    for i in range(n):
        k = int(rng.integers(3, 21))
        out[i, 0], out[i, 1: k + 1], out[i, k + 1] = 998, rng.integers(0, 998, k), 999
    return torch.as_tensor(out)


def null_tokens():
    """The empty prompt: BOS, EOS, zeros."""
    out = torch.zeros(1, 77, dtype=torch.long)
    out[0, :2] = torch.tensor([998, 999])
    return out


def gap(got, want):
    return float((got.float() - want).abs().max() / want.abs().max())


def unet_inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, h = N * cfg.num_frames, cfg.image_size
    x = torch.randn(B, h, h, cfg.in_channels, generator=g)
    t = torch.full((B,), 381, dtype=torch.long)
    ctx = torch.randn(N, 77, cfg.context_dim, generator=g).repeat_interleave(cfg.num_frames, 0)
    cam = torch.cat([get_camera(cfg.num_frames, 15.0, a) for a in (30.0, 250.0)])
    return x, t, ctx, cam


@torch.no_grad()
def test_unet_matches_reference(pair):
    model, ref = pair
    x, t, ctx, cam = unet_inputs(model.cfg)
    want = ref.unet(x.permute(0, 3, 1, 2), t, ctx, cam).permute(0, 2, 3, 1)
    assert gap(model.unet(x, t, ctx, camera=cam), want) < TOL


@torch.no_grad()
def test_unet_with_attn1_per_view_misses_reference(pair):
    """The mechanism: the same program with every attn1 over one view's
    tokens misses the reference by at least 100 TOL."""
    model, ref = pair
    per_view = copy.deepcopy(model)
    blocks = [b for b in per_view.modules() if isinstance(b, BasicTransformerBlock)]
    assert blocks and all(b.num_frames == 4 for b in blocks)
    for b in blocks:
        b.num_frames = 1
    x, t, ctx, cam = unet_inputs(model.cfg, seed=1)
    want = ref.unet(x.permute(0, 3, 1, 2), t, ctx, cam).permute(0, 2, 3, 1)
    assert gap(model.unet(x, t, ctx, camera=cam), want) < TOL
    assert gap(per_view.unet(x, t, ctx, camera=cam), want) > 100 * TOL


@torch.no_grad()
def test_text_tower_matches_reference(pair):
    model, ref = pair
    tok = torch.cat([null_tokens(), tokens(3, 1)])
    want = ref_mod.encode_text(ref, tok)
    assert want.shape == (4, 77, model.cfg.text_width)
    assert gap(model.encode_text(tok), want) < TOL


@torch.no_grad()
def test_text_tower_is_causal(pair):
    """Changing the token at position j leaves positions < j as they were
    and changes position j."""
    model, _ = pair
    tok = tokens(1, 2)
    out = model.encode_text(tok)
    for j in (1, 5, 40):
        other = tok.clone()
        other[0, j] = (other[0, j] + 17) % 998
        out2 = model.encode_text(other)
        assert torch.equal(out2[0, :j], out[0, :j]), j
        assert not torch.allclose(out2[0, j], out[0, j]), j


@pytest.mark.parametrize("azimuth_start", [0.0, 90.0, 213.7])
def test_get_camera_matches_reference(azimuth_start):
    got = get_camera(4, 15.0, azimuth_start, 360.0)
    want = ref_mod.get_camera(4, 15.0, azimuth_start, 360.0)
    assert got.shape == (4, 16) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # rigid camera-to-world: orthonormal rotation, the centre on the unit sphere
    m = got.reshape(4, 4, 4).double()
    torch.testing.assert_close(m[:, :3, :3] @ m[:, :3, :3].transpose(1, 2), torch.eye(3).expand(4, 3, 3).double(),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(m[:, :3, 3].norm(dim=1), torch.ones(4).double(), atol=1e-6, rtol=0)


@torch.no_grad()
def test_decode_matches_reference(pair):
    model, ref = pair
    z = torch.randn(3, model.cfg.image_size, model.cfg.image_size, 4, generator=torch.Generator().manual_seed(3))
    assert gap(model.decode_latents(z), ref_mod.decode(ref, z)) < TOL


@torch.no_grad()
def test_cfg_sample_matches_reference(pair):
    """A 4-step DDIM sample at eta 0 and CFG 10 of two requests in one pass
    against the reference's, request by request (uniform timesteps take
    no 3 steps: 1000 // 3 strides give four)."""
    model, ref = pair
    cfg = model.cfg
    tok = tokens(N, 4)
    null = null_tokens()
    ctx, uc = model.encode_text(tok), model.encode_text(null)
    azim = (12.0, 200.0)
    cam = torch.stack([get_camera(cfg.num_frames, 15.0, a) for a in azim])
    init = torch.randn(N, cfg.num_frames, cfg.image_size, cfg.image_size, 4, generator=torch.Generator().manual_seed(6))
    res = ddim_sample_views(model, ctx, uc, cam, CFG_SCALE, num_steps=STEPS, init_noise=init)
    assert res.latents.shape == init.shape
    ref_uc = ref_mod.encode_text(ref, null)
    for n in range(N):
        want = ref_mod.ddim_sample(ref, ref_mod.encode_text(ref, tok[n: n + 1]), ref_uc,
                                   ref_mod.get_camera(cfg.num_frames, 15.0, azim[n]), init[n], CFG_SCALE, STEPS)
        assert gap(res.latents[n], want) < TOL, n
    # drawn from per-request generators, a request's noise does not depend on its batch mates
    gens = lambda: [torch.Generator().manual_seed(100 + n) for n in range(N)]
    both = ddim_sample_views(model, ctx, uc, cam, CFG_SCALE, num_steps=1, generators=gens()).latents
    alone = ddim_sample_views(model, ctx[1:], uc, cam[1:], CFG_SCALE, num_steps=1, generators=gens()[1:]).latents
    torch.testing.assert_close(both[1], alone[0], rtol=1e-5, atol=1e-5)


def _sites(model) -> int:
    return sum(isinstance(b, BasicTransformerBlock) and b.num_frames > 1 for b in model.modules())


@torch.no_grad()
def test_spans_of_a_pass(pair):
    """One pass records sample.pass, one sample.step a step, inside each
    one model.unet and one model.mvattn a site (16 at the published
    layout), and model.text for each encode_text call."""
    model, _ = pair
    with torch.device("meta"):
        assert _sites(MVDream(MVDreamConfig(), device="meta")) == 16
    sites = _sites(model)
    assert sites == 10  # tiny: 3 input, 1 middle, 6 output
    trace.clear()
    tok = tokens(N, 7)
    ctx, uc = model.encode_text(tok), model.encode_text(tok[:1])
    cam = torch.stack([get_camera(4, 15.0, a) for a in (0.0, 45.0)])
    ddim_sample_views(model, ctx, uc, cam, CFG_SCALE, num_steps=STEPS,
                      generators=[torch.Generator().manual_seed(n) for n in range(N)])
    recs = trace.records()
    names = [r.name for r in recs]
    assert names.count("model.text") == 2 and names.count("sample.pass") == 1
    steps = [r for r in recs if r.name == "sample.step"]
    assert [s.step for s in steps] == list(range(STEPS))
    byid = {r.id: r for r in recs}
    for s in steps:
        inside = [r for r in recs if r.pass_id == s.pass_id and r.step == s.step and r is not s]
        assert sorted({r.name for r in inside}) == ["model.mvattn", "model.unet"]
        assert [r.name for r in inside].count("model.unet") == 1
        assert [r.name for r in inside].count("model.mvattn") == sites
        assert all(byid[r.parent].name == "model.unet" for r in inside if r.name == "model.mvattn")
        assert all(r.end_ns is not None for r in inside)


def test_state_dict_names_are_the_checkpoints():
    """The program's parameters at the published sizes carry the
    reference's names and shapes (the checkpoint's), one for one."""
    cfg = MVDreamConfig()
    with torch.device("meta"):
        got = {k: tuple(v.shape) for k, v in MVDream(cfg, device="meta").state_dict().items()}
        want = {k: tuple(v.shape) for k, v in ref_mod.MVDream(dataclasses.asdict(cfg)).state_dict().items()}
    assert got == want
    heads = {b.attn1.heads for b in MVDream(cfg, device="meta").modules() if isinstance(b, BasicTransformerBlock)}
    assert heads == {5, 10, 20}


def test_default_unet_is_mvdfusions():
    """UNetModel()'s defaults build MVD-Fusion's UNet: its state-dict keys
    and shapes, in order, as before the MVDream options, and every site
    per view."""
    with torch.device("meta"):
        u = UNetModel()
    layout = ";".join(f"{k}:{tuple(v.shape)}" for k, v in u.state_dict().items())
    assert hashlib.sha256(layout.encode()).hexdigest() == MVDF_UNET_LAYOUT
    assert sum(p.numel() for p in u.parameters()) == MVDF_UNET_PARAMS
    assert not hasattr(u, "camera_embed")
    assert all(b.num_frames == 1 for b in u.modules() if isinstance(b, BasicTransformerBlock))


def test_chip_smoke_mvdream_rehearsal_on_cpu():
    """chip_smoke.py's mvdream phase at the tiny config on the CPU: the same
    control flow and checks as on the card, minus the launch counts."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.run_mvdream("cpu", device="cpu", cfg=MVDreamConfig().tiny()) == {}
