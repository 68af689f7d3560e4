"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test decides inside its fixture whether there is a card
and skips without one. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest

Tolerance: max|kernel - plain| <= tol x max(1, max|plain|), tol 1e-4 in fp32
(the same math in another sum order) and 3e-2 in bf16 (roundings at other
points of chained bf16 products); K2's bf16 tensor-core tile, the wgmma
site GEMM and the view attention, which round where their plain versions
round, 1 bf16 ulp of max|plain| and a mean of 1e-4 x max|plain| (the GEMM's
fp32 outputs: 1e-4 x max(1, max|plain|)); K4 and K4b in bf16, 1 bf16 ulp of
max|plain| and a mean of 3e-4 x max|plain|. TF32 is off for the plain
versions.
"""

import collections
import math

import pytest
import torch

from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops import attention as K2
from mvdfusion_tpu_torch.ops import block as K3
from mvdfusion_tpu_torch.ops import conv3x3 as K8
from mvdfusion_tpu_torch.ops import crossview as K4
from mvdfusion_tpu_torch.ops import groupnorm as K1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, dev, dt, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dt)


GPU_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _gpu_close(got, want, dt):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL[dt] * scale, f"max|diff| {err:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k1_k2_kernels_match_plain(cuda, dt):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = _rand(g, cuda, dt, 4, 256, 320, std=3.0)
    w, b = 1 + _rand(g, cuda, torch.float32, 320, std=0.1), _rand(g, cuda, torch.float32, 320, std=0.1)
    _gpu_close(K1.launch_group_norm(x, w, b, 32, 1e-5, "silu"), K1.group_norm_plain(x, w, b, 32, 1e-5, "silu"), dt)
    for shape in ((1, 257, 16, 64), (1, 1024, 1, 512), (2, 1024, 8, 40)):
        q, k, v = (_rand(g, cuda, dt, *shape) for _ in range(3))
        _gpu_close(K2.launch_attention(q, k, v, shape[-1] ** -0.5), K2.attention_plain(q, k, v, shape[-1] ** -0.5), dt)


def _close_ulp(got, want, mean_tol=1e-4):
    """bf16: max|kernel - plain| <= 1 bf16 ulp of max|plain|, mean <= mean_tol
    x max|plain| (both sides round at the same points; only roundings split
    by an fp32 difference remain)."""
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert err.max().item() <= ulp, f"max|diff| {err.max().item():.3e} > 1 ulp {ulp:.3e}"
    assert err.mean().item() <= mean_tol * top, f"mean|diff| {err.mean().item():.3e} > {mean_tol:g} x {top:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", [K2.MODE_PROBS, K2.MODE_PV])
@pytest.mark.parametrize("dh", [40, 64, 80, 128])
def test_gpu_k2_tensor_core_tile_matches_plain(cuda, mode, dh):
    """The bf16 tile in each rounding form: q/k/v as strided views of one
    packed (B, N, 3, H, dh) buffer, as K3 passes them, at N = 257 (a ragged
    key tile and a ragged query tile); then separate buffers with Nq = 100
    queries against Nk = 257 keys. Two runs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(8)
    B, H, N = 2, 3, 257
    qkv = _rand(g, cuda, torch.bfloat16, B, N, 3, H, dh)
    cases = [(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
             (_rand(g, cuda, torch.bfloat16, B, 100, H, dh),) + tuple(_rand(g, cuda, torch.bfloat16, B, N, H, dh)
                                                                     for _ in range(2))]
    for q, k, v in cases:
        got = K2.launch_attention(q, k, v, dh**-0.5, mode)
        _close_ulp(got, K2.attention_plain(q, k, v, dh**-0.5, mode))
        assert torch.equal(got, K2.launch_attention(q, k, v, dh**-0.5, mode))


K2_JOINED = [(2, 4096, 5, 64), (2, 1024, 10, 64), (2, 256, 20, 64)]  # MVDream's attn1, 4 views joined


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "separate"])
@pytest.mark.parametrize("shape", K2_JOINED, ids=lambda s: f"{s[1]}keys")
def test_gpu_k2_sm90_tile_matches_plain_at_the_joined_shapes(cuda, shape, layout):
    """The wgmma tile (attention_route "sm90") in the pv form at MVDream's
    three joined attn1 shapes, q/k/v as strided views of one packed (B, N,
    3, H, dh) buffer and as separate buffers: 1 bf16 ulp, a mean of 1e-4 x
    max|plain|; two runs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(26)
    B, N, H, dh = shape
    if layout == "packed":
        qkv = _rand(g, cuda, torch.bfloat16, B, N, 3, H, dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (_rand(g, cuda, torch.bfloat16, B, N, H, dh) for _ in range(3))
    assert K2.attention_route(q, k, v, dh**-0.5) == "sm90"
    got = K2.launch_attention(q, k, v, dh**-0.5)
    _close_ulp(got, K2.attention_plain(q, k, v, dh**-0.5, K2.MODE_PV))
    assert torch.equal(got, K2.launch_attention(q, k, v, dh**-0.5))


@pytest.mark.gpu
def test_gpu_k2_launches_counted_by_route(cuda):
    """fused_attention counts the joined shapes' two launches (the row max,
    then the main pass) under attention_sm90, and CLIP's 257 ragged keys and
    a 32^2 site's dh 40 under attention."""
    g = torch.Generator(device=cuda).manual_seed(27)
    cases = [(s, "attention_sm90", 2) for s in K2_JOINED] + [((1, 257, 16, 64), "attention", 1),
                                                              ((2, 1024, 8, 40), "attention", 1)]
    for shape, key, n in cases:
        q, k, v = (_rand(g, cuda, torch.bfloat16, *shape) for _ in range(3))
        before = _lib.counted()
        K2.fused_attention(q, k, v, shape[-1] ** -0.5)
        assert _lib.counted() - before == collections.Counter({key: n}), (shape, key)


def _site_weights(g, dev, dt, C):
    lin = lambda o, i: _rand(g, dev, dt, o, i, std=i**-0.5)
    vec = lambda n: _rand(g, dev, torch.float32, n, std=0.1)
    return K3.BlockWeights(
        gn_w=1 + vec(C), gn_b=vec(C), pi_w=lin(C, C), pi_b=vec(C), ln1_w=1 + vec(C), ln1_b=vec(C),
        qkv_w=lin(3 * C, C), out_w=lin(C, C), out_b=vec(C), ln3_w=1 + vec(C), ln3_b=vec(C),
        g_w=lin(8 * C, C), g_b=vec(8 * C), f_w=lin(C, 4 * C), f_b=vec(C), po_w=lin(C, C), po_b=vec(C))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k3_kernel_matches_plain(cuda, dt):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, N, C, heads = 2, 256, 320, 8
    w = _site_weights(g, cuda, dt, C)
    x = _rand(g, cuda, dt, B, N, C)
    for a2 in (_rand(g, cuda, dt, B, C), _rand(g, cuda, dt, B, N, C)):
        _gpu_close(K3.launch_transformer_block(x, a2, w, heads), K3.transformer_block_plain(x, a2, w, heads), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k5_kernel_matches_plain(cuda, dt):
    """The one-kernel site at a 32^2 C=320 site (B=2) and a small ragged one
    (N=96: partial GEMM and attention tiles), attn2 row and map; in bf16 its
    attention phase is the tensor-core tile. Two runs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for B, N, C, heads in ((2, 1024, 320, 8), (3, 96, 64, 4)):
        w = _site_weights(g, cuda, dt, C)
        x = _rand(g, cuda, dt, B, N, C)
        for a2 in (_rand(g, cuda, dt, B, C), _rand(g, cuda, dt, B, N, C)):
            got = K3.launch_transformer_block_single(x, a2, w, heads)
            _gpu_close(got, K3.transformer_block_plain(x, a2, w, heads), dt)
            assert torch.equal(got, K3.launch_transformer_block_single(x, a2, w, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("dt,C,heads", [(torch.float32, 256, 4), (torch.bfloat16, 1280, 8)])
def test_gpu_k6_kernel_matches_plain(cuda, dt, C, heads):
    """The big-C site and its attention kernel alone at N=64 and N=256 (the
    512^2 stretch's C=1280 16^2 sites), attn2 row and map."""
    g = torch.Generator(device=cuda).manual_seed(5)
    w = _site_weights(g, cuda, dt, C)
    for B, N in ((3, 64), (2, 256)):
        ln1 = _rand(g, cuda, dt, B, N, C)
        _gpu_close(K3.launch_big_attention(ln1, w.qkv_w, heads), K3.qkv_attention_plain(ln1, w.qkv_w, heads), dt)
        x = _rand(g, cuda, dt, B, N, C)
        for a2 in (_rand(g, cuda, dt, B, C), _rand(g, cuda, dt, B, N, C)):
            _gpu_close(K3.launch_transformer_block_big(x, a2, w, heads),
                       K3.transformer_block_big_plain(x, a2, w, heads), dt)


@pytest.mark.gpu
def test_gpu_k5_wgmma_site_against_k3(cuda):
    """K5 in bf16 at the flagship's 32^2 site (16, 1024, 320): its wgmma
    phases take the split form's epilogue kinds, so it rounds where K3
    rounds, and only its GroupNorm sums in another order than K1; a value
    that rounds the other way there moves through the site's ten chained
    bf16 roundings. Held to 1 bf16 ulp of max|K3| and a mean of 3e-4 x
    max|K3| on the same inputs (the bound of K4's chained layers), max|diff|
    printed in bf16 ulps. Two launches give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    B, N, C, heads = 16, 1024, 320, 8
    w = K3.prepare_site_weights(_site_weights(g, cuda, torch.bfloat16, C), torch.bfloat16)
    x, a2 = _rand(g, cuda, torch.bfloat16, B, N, C), _rand(g, cuda, torch.bfloat16, B, C)
    got = K3.launch_transformer_block_single(x, a2, w, heads)
    k3 = K3.launch_transformer_block(x, a2, w, heads)
    top = k3.float().abs().max().item()
    print(f"K5 vs K3: {(got.float() - k3.float()).abs().max().item() / 2.0 ** (math.floor(math.log2(top)) - 7):.2f} "
          "bf16 ulp of max|K3|")
    _close_ulp(got, k3, mean_tol=3e-4)
    assert torch.equal(got, K3.launch_transformer_block_single(x, a2, w, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("N,consumers", [(64, 1), (64, 2), (128, None), (192, None), (256, None)])
def test_gpu_k6_attention_matches_plain(cuda, N, consumers):
    """K6's attention kernel in bf16 at C=1280, 8 heads, B=3 (an odd batch:
    the last tensor-core block holds one batch element at N=64 with two
    warpgroups): the tensor-core tile at N = 64 (one and two warpgroups a
    block) and 128, the CUDA-core kernel at 192 and 256; 1 bf16 ulp of
    max|plain| and a mean of 1e-4 x max|plain|; two launches give the same
    bits."""
    g = torch.Generator(device=cuda).manual_seed(10)
    B, C, heads = 3, 1280, 8
    ln1 = _rand(g, cuda, torch.bfloat16, B, N, C)
    qkv_w = _rand(g, cuda, torch.bfloat16, 3 * C, C, std=C**-0.5)
    got = K3.launch_big_attention(ln1, qkv_w, heads, consumers)
    _close_ulp(got, K3.qkv_attention_plain(ln1, qkv_w, heads))
    assert torch.equal(got, K3.launch_big_attention(ln1, qkv_w, heads, consumers))


def _k4_inputs(g, dev, dt, V, Hh, hid, L, heads, out_dim, nh=7, N=None):
    """K4's operands; N points (default V * Hh^2) over V maps of Hh^2."""
    mlp, G = 2 * hid, 7 * (1 + 2 * nh)
    N = N or V * Hh * Hh
    r = lambda *s, std=1.0, d=torch.float32: _rand(g, dev, d, *s, std=std)
    lin = lambda o, i: r(o, i, std=i**-0.5, d=dt)
    w = K4.AggregatorWeights(
        qkv_w=[lin(3 * hid, hid) for _ in range(L)], qkv_b=[r(3 * hid, std=0.1) for _ in range(L)],
        proj_w=[lin(hid, hid) for _ in range(L)], proj_b=[r(hid, std=0.1) for _ in range(L)],
        fc1_w=[lin(mlp, hid) for _ in range(L)], fc1_b=[r(mlp, std=0.1) for _ in range(L)],
        fc2_w=[lin(hid, mlp) for _ in range(L)], fc2_b=[r(hid, std=0.1) for _ in range(L)],
        mods=r(L, 6, hid, std=0.5), wl_w=lin(1, hid), wl_b=r(1, std=0.1), fin_w=lin(out_dim, hid),
        fin_b=r(out_dim, std=0.1))
    kg = K4.GeoWeights(kall=r(G, hid, std=G**-0.5, d=dt), kmask=r(hid, std=0.1))
    return (r(V, N, 2, std=0.6), r(N, 3), r(V, 3, std=2.0), torch.ones(V, device=dev), r(N, hid, d=dt),
            r(V, Hh, Hh, hid, d=dt), kg, w, heads, tuple(0.1 * 2.0**i for i in range(nh)))


# bf16 K4 at 1 bf16 ulp of max|plain| and a mean of 3e-4 x max|plain| (the
# bounds of the full-width GridAttn test against the reference,
# test_torch_port_eval.py::test_gridattn_bf16_full_width_matches): V = 1..16
# views, N = 1001 points, not a multiple of the qkv tile's floor(128 / V)
K4_VIEWS = [1, 3, 8, 15, 16]
K4_BF16 = dict(Hh=16, hid=256, L=2, heads=8, out_dim=96, N=1001)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,V", [(torch.float32, 4)] + [(torch.bfloat16, V) for V in K4_VIEWS])
def test_gpu_k4_kernel_matches_plain(cuda, dt, V):
    """The single form (the tensor-core gather, the qkv tile with the view
    attention at bf16; the CUDA-core gather and the standalone attention in
    fp32): fp32 within GPU_TOL, bf16 at the ulp bounds above."""
    g = torch.Generator(device=cuda).manual_seed(2)
    if dt == torch.float32:
        args = _k4_inputs(g, cuda, dt, V=V, Hh=16, hid=256, L=2, heads=8, out_dim=96)
        _gpu_close(K4.launch_crossview(*args), K4.crossview_plain(*args), dt)
    else:
        args = _k4_inputs(g, cuda, dt, V=V, **K4_BF16)
        _close_ulp(K4.launch_crossview(*args), K4.crossview_plain(*args), mean_tol=3e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,shape", [
    (torch.float32, dict(V=3, Hh=8, hid=64, L=2, heads=4, out_dim=48)),
    (torch.bfloat16, dict(V=15, Hh=32, hid=256, L=3, heads=8, out_dim=768)),  # the 15-view evaluation
] + [(torch.bfloat16, dict(V=V, **K4_BF16)) for V in K4_VIEWS])
def test_gpu_k4_two_phase_matches_plain(cuda, dt, shape):
    """The two-phase form: phase-1 tokens within 1 bf16 ulp of the plain
    tokens rounded to bf16 plus the bound on the two fp32 sums' difference
    (crossview.gather_tokens_bound; 1e-4 in fp32); the gather's fp32 stream
    GELU(float(token) + b_acc) of its own tokens within fp32 rounding; the
    output within GPU_TOL in fp32 and at the ulp bounds above in bf16."""
    g = torch.Generator(device=cuda).manual_seed(3)
    args = _k4_inputs(g, cuda, dt, **shape)
    geo = args[:4] + (args[5], args[6], args[9])
    tok = K4.launch_gather_tokens(*geo).float()
    want = K4.gather_tokens_plain(*geo).to(dt).transpose(0, 1).float()
    if dt == torch.bfloat16:
        ulp = (tok.abs().maximum(want.abs()).clamp_min(2.0**-126).log2().floor() - 7).exp2()
        allow = ulp + K4.gather_tokens_bound(*geo).transpose(0, 1)
        worst = ((tok - want).abs() / allow).max().item()
        assert worst <= 1.0, f"phase-1 tokens differ by {worst:.3f} of 1 bf16 ulp + the sum bound"
    else:
        _gpu_close(tok, want, dt)
    stream = K4.launch_gather(*args[:6], args[6], args[9], "two_phase")
    folded = torch.nn.functional.gelu(tok + args[4].float()[:, None, :]).reshape(stream.shape)
    _gpu_close(stream, folded, torch.float32)
    got, ref = K4.launch_crossview_two_phase(*args), K4.crossview_two_phase_plain(*args)
    if dt == torch.bfloat16:
        _close_ulp(got, ref, mean_tol=3e-4)
    else:
        _gpu_close(got, ref, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("V", K4_VIEWS)
def test_gpu_k4_view_attention_routes_match_plain(cuda, V):
    """The qkv tile with the view attention and the standalone route (fp32
    qkv GEMM + attention kernel) against view_attention_plain in bf16, N
    ragged against the tile: 1 bf16 ulp of max|plain|, mean 1e-4 x max|plain|;
    two runs of the tile give the same bits; each route counts under its own
    name."""
    from mvdfusion_tpu_torch.ops import _lib

    g = torch.Generator(device=cuda).manual_seed(11)
    bf, N, hid, heads = torch.bfloat16, 1001, 256, 8
    args = _k4_inputs(g, cuda, bf, V=V, Hh=4, hid=hid, L=1, heads=heads, out_dim=96, N=N)
    w = K4.prepare_crossview_weights(args[6], args[7], bf, heads, args[9])[1]
    h = _rand(g, cuda, bf, N * V, hid)
    want = K4.view_attention_plain(h, w.qkv_w[0], w.qkv_b[0], V, heads)
    _lib.reset_launches()
    fused = K4.view_attention(h, w.qkv_w[0], w.qkv_b[0], V, heads)
    alone = K4.view_attention(h, w.qkv_w[0], w.qkv_b[0], V, heads, route="standalone")
    assert dict(_lib.LAUNCHES) == {"cv_qkv_attention": 1, "cv_attention": 1, "gemm_sm90": 1}
    _close_ulp(fused, want)
    _close_ulp(alone, want)
    assert torch.equal(fused, K4.view_attention(h, w.qkv_w[0], w.qkv_b[0], V, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hid,heads", [(32, 4), (64, 4), (96, 4), (160, 4), (192, 4), (224, 4), (256, 4)])
def test_gpu_k4_standalone_attention_head_widths(cuda, dt, hid, heads):
    """The standalone view attention at every head width dh = hid / heads in
    8..64 (the learning proof's medium GridAttn: hid 96, 4 heads, dh 24),
    V = 16, in fp32 and bf16, against view_attention_plain: fp32 1e-4 x
    max(1, max|plain|), bf16 1 ulp of max|plain| and a mean of 1e-4 x
    max|plain|."""
    g = torch.Generator(device=cuda).manual_seed(hid)
    V, N = 16, 257
    qkv_w = _rand(g, cuda, dt, 3 * hid, hid, std=hid**-0.5)
    qkv_b = _rand(g, cuda, torch.float32, 3 * hid, std=0.1)
    h = _rand(g, cuda, dt, N * V, hid)
    got = K4.view_attention(h, qkv_w, qkv_b, V, heads, route="standalone")
    want = K4.view_attention_plain(h, qkv_w, qkv_b, V, heads)
    if dt == torch.bfloat16:
        _close_ulp(got, want)
    else:
        _gpu_close(got, want, dt)


# K1's (N, C) at every GroupNorm of a UNet step (nn/unet.py), each at the
# CFG batch of the flagship (16) or of the eval step (30), and the VAE's
# 32^2 x 512 maps at the flagship's encode batch of 9
K1_STEP_SHAPES = [(16, 1024, 320), (30, 1024, 320), (16, 1024, 640), (30, 1024, 960), (30, 256, 320),
                  (16, 256, 640), (30, 256, 960), (16, 256, 1280), (30, 256, 1920), (16, 64, 640), (30, 64, 1280),
                  (16, 64, 1920), (30, 64, 2560), (16, 16, 1280), (30, 16, 2560), (9, 1024, 512)]
# one sample, ragged row counts, 4 channels a group
K1_EDGE_SHAPES = [(1, 1024, 960), (1, 16, 320), (3, 1000, 320), (2, 77, 640), (5, 3, 2560), (2, 100, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_gpu_k1_step_shapes_match_plain(cuda, dt):
    """K1 at every shape of the flagship and eval steps, the VAE's 32^2 maps
    and edge shapes, SiLU at eps 1e-5 (the ResBlocks) and none at 1e-6 (the
    sites): bf16 within 1 bf16 ulp of max|plain| and a mean of 3e-4 x
    max|plain|, fp32 within 1e-5 x max|plain| (fp32 sums in another order);
    a second launch gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(11)
    for B, N, C in K1_STEP_SHAPES + K1_EDGE_SHAPES:
        x = _rand(g, cuda, dt, B, N, C, std=3.0) + 1
        w, b = 1 + _rand(g, cuda, torch.float32, C, std=0.1), _rand(g, cuda, torch.float32, C, std=0.1)
        for act, eps in (("silu", 1e-5), ("none", 1e-6)):
            got, want = K1.launch_group_norm(x, w, b, 32, eps, act), K1.group_norm_plain(x, w, b, 32, eps, act)
            if dt == torch.bfloat16:
                _close_ulp(got, want, mean_tol=3e-4)
            else:
                err, top = (got - want).abs().max().item(), want.abs().max().item()
                assert err <= 1e-5 * top, f"{(B, N, C)} {act}: max|diff| {err:.3e} > 1e-5 x {top:.3e}"
            assert torch.equal(got, K1.launch_group_norm(x, w, b, 32, eps, act)), f"{(B, N, C)} {act}: runs differ"


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_gpu_site_layernorm_matches_plain(cuda, dt):
    """block.cu's LayerNorm at the sites' three widths against _ln_plain (the
    reference's E[x^2] - mean^2, clamped at 0): rows at the residual stream's
    scale (mean 4, std 1), rows of N(0, 1), and constant rows (the clamp
    acts); bf16 within 1 bf16 ulp of max|plain| and a mean of 3e-4 x
    max|plain|, fp32 within 1e-5 x max|plain|. Also a ragged row count and a
    narrow C (4 lanes a row); a second launch gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(12)
    for M, C in ((16384, 320), (4096, 640), (1024, 1280), (999, 320), (33, 64)):
        x = torch.cat([_rand(g, cuda, torch.float32, M // 2, C) + 4, _rand(g, cuda, torch.float32, M - M // 2 - 3, C),
                       torch.full((3, C), 2.5, device=cuda)]).to(dt)
        w, b = 1 + _rand(g, cuda, torch.float32, C, std=0.1), _rand(g, cuda, torch.float32, C, std=0.1)
        got, want = K3.layernorm(x, w, b), K3._ln_plain(x, w, b)
        if dt == torch.bfloat16:
            _close_ulp(got, want, mean_tol=3e-4)
        else:
            err, top = (got - want).abs().max().item(), want.abs().max().item()
            assert err <= 1e-5 * top, f"{(M, C)}: max|diff| {err:.3e} > 1e-5 x {top:.3e}"
        assert torch.equal(got[-3:], want[-3:]), f"{(M, C)}: constant rows are not beta"
        assert torch.equal(got, K3.layernorm(x, w, b))


# K7's shapes: ragged last tiles (N = 3000, 700), 8 groups of 5 channels at
# C = 40; the VAE's large maps: the decoder's 64^2 x 512 and 256^2 x 128 at
# B = 8, the encoder's 128^2 x 256 at B = 9, the eval chunk's 128^2 x 512 at
# B = 7
K7_SHAPES = [(2, 3000, 96), (3, 700, 40), (8, 4096, 512), (8, 65536, 128), (9, 16384, 256), (7, 16384, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k7_groupnorm_tiled_matches_plain(cuda, dt):
    """The tiled GroupNorm (its one-launch stats pass with the fold, then the
    apply pass; whole and launched pass by pass) at K7_SHAPES against its
    plain version:
    bf16 within 1 bf16 ulp of max|plain| and a mean of 3e-4 x max|plain|,
    fp32 within 1e-4 x max|plain| (fp32 sums in another order); gn_fold_
    affine's unclamped fold within 1e-4 x max|plain|. The stats pass adds
    its partials in a fixed order and its folding CTA resets the sample's
    counter: three launches in a row give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for shape in K7_SHAPES:
        x = _rand(g, cuda, dt, *shape, std=3.0) + 1
        C = shape[-1]
        w, b = 1 + _rand(g, cuda, torch.float32, C, std=0.1), _rand(g, cuda, torch.float32, C, std=0.1)
        groups = 8 if C == 40 else 32
        for act in ("none", "silu"):
            want = K1.group_norm_tiled_plain(x, w, b, groups, 1e-6, act)
            runs = [K1.launch_group_norm_tiled(x, w, b, groups, 1e-6, act) for _ in range(3)]
            a, sh = K1.launch_fold(x, w, b, groups, 1e-6, True)
            runs.append(K1.launch_apply_affine(x, a, sh, act))
            for got in runs:
                if dt == torch.bfloat16:
                    _close_ulp(got, want, mean_tol=3e-4)
                else:
                    err, top = (got - want).abs().max().item(), want.abs().max().item()
                    assert err <= 1e-4 * top, f"{shape} {act}: max|diff| {err:.3e} > 1e-4 x {top:.3e}"
                assert torch.equal(got, runs[0]), f"{shape} {act}: runs differ"
        folds = [K8.launch_gn_fold_affine(x, w, b, groups, 1e-6) for _ in range(3)]
        pa, pb = K8.gn_fold_affine_plain(x, w, b, groups, 1e-6)
        for ka, kb in folds:
            for got, want in ((ka, pa), (kb, pb)):
                err, top = (got - want).abs().max().item(), want.abs().max().item()
                assert err <= 1e-4 * top, f"{shape} fold: max|diff| {err:.3e} > 1e-4 x {top:.3e}"
            assert torch.equal(ka, folds[0][0]) and torch.equal(kb, folds[0][1]), f"{shape}: folds differ"
        _gpu_close(K1.launch_apply_affine(x, pa, pb, "silu"), K1.apply_affine_plain(x, pa, pb, "silu"), dt)


@pytest.mark.gpu
def test_gpu_group_norm_act_leaves_plain_what_k7_cannot_take(cuda, monkeypatch):
    """A CUDA map above 2^20 elements whose C K7 cannot take (C = 2048, above
    GNT_MAX_C) runs the plain GroupNorm, ungated and with MVDF_GN_TILED=1
    (where the reference's _pick_tile finds a tile), without a launch; a
    map K7 takes launches it."""
    from mvdfusion_tpu_torch.ops import _lib

    g = torch.Generator(device=cuda).manual_seed(7)
    w, b = 1 + _rand(g, cuda, torch.float32, 2048, std=0.1), _rand(g, cuda, torch.float32, 2048, std=0.1)
    x = _rand(g, cuda, torch.bfloat16, 1, 4096, 2048) + 1
    for gn_tiled in (False, True):
        if gn_tiled:
            monkeypatch.setenv("MVDF_GN_TILED", "1")
        else:
            monkeypatch.delenv("MVDF_GN_TILED", raising=False)
        _lib.reset_launches()
        got = K1.group_norm_act(x, w, b, 32, 1e-6, "silu")
        assert _lib.LAUNCHES["groupnorm_tiled"] == 0 and _lib.LAUNCHES["groupnorm"] == 0, dict(_lib.LAUNCHES)
        assert torch.equal(got, K1.group_norm_plain(x, w, b, 32, 1e-6, "silu"))
    _lib.reset_launches()
    K1.group_norm_act(x[..., :1024].contiguous(), w[:1024], b[:1024], 32, 1e-6, "silu")
    assert _lib.LAUNCHES["groupnorm_tiled"] == 1, dict(_lib.LAUNCHES)


@pytest.mark.gpu
def test_gpu_vae_decode_takes_k7_at_every_large_map(cuda, monkeypatch):
    """One full-width VAE decode of 8 latents (bf16 convs, fp32 norms, random
    weights) on the default route: K7 at each of the decoder's 19 GroupNorms
    above 2^20 elements an image, K1 at its 11 at 32^2, the plain GroupNorm
    never."""
    import os

    from mvdfusion_tpu_torch.nn.layers import GroupNorm32
    from mvdfusion_tpu_torch.nn.vae import AutoencoderKL
    from mvdfusion_tpu_torch.nn.viewfusion import randomize_
    from mvdfusion_tpu_torch.ops import _lib

    for var in ("MVDF_GN_TILED", "MVDF_CONV3X3"):
        monkeypatch.delenv(var, raising=False)
    assert not os.environ.get("MVDF_GN_TILED")
    plain = []
    real = K1.group_norm_plain
    monkeypatch.setattr(K1, "group_norm_plain", lambda *a: plain.append(a[0].shape) or real(*a))
    vae = randomize_(AutoencoderKL().to(cuda), seed=0)
    norms = {id(p) for m in vae.modules() if isinstance(m, GroupNorm32) for p in m.parameters()}
    for p in vae.parameters():
        if id(p) not in norms:
            p.data = p.data.to(torch.bfloat16)
    z = torch.randn(8, 32, 32, 4, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    _lib.reset_launches()
    with torch.no_grad():
        img = vae.decode(z)
    torch.cuda.synchronize()
    assert tuple(img.shape) == (8, 256, 256, 3) and bool(torch.isfinite(img.float()).all())
    assert _lib.LAUNCHES["groupnorm_tiled"] == 19 and _lib.LAUNCHES["groupnorm"] == 11, dict(_lib.LAUNCHES)
    assert plain == []


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k8_conv3x3_matches_plain(cuda, dt):
    """The fused GN-affine + SiLU + conv at edge shapes: H not a multiple of
    the row tile (TX 32 x TR 4 over H=21; TX 16 x TR 8 over H=9), W not a
    multiple of the column tile (136 and 40), the B=7 chunk, Cin of one
    16-channel slice, Cout below or not a multiple of the channel tile (8,
    24, 64), two and four column tiles (Cout 256 at W=64, 512 at W=16), with
    and without a residual, and act="none" with the identity affine. Two runs
    give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for B, H, W, Cin, Cout, with_res in ((2, 21, 40, 32, 64, True), (7, 19, 64, 128, 128, True),
                                         (1, 9, 136, 64, 8, False), (2, 9, 16, 16, 24, True),
                                         (2, 12, 64, 64, 256, True), (1, 20, 16, 32, 512, False)):
        x = _rand(g, cuda, dt, B, H, W, Cin)
        a, b = 1 + _rand(g, cuda, torch.float32, B, Cin, std=0.3), _rand(g, cuda, torch.float32, B, Cin, std=0.2)
        w = _rand(g, cuda, dt, Cout, Cin, 3, 3, std=(9 * Cin) ** -0.5)
        bias, row = _rand(g, cuda, torch.float32, Cout, std=0.1), _rand(g, cuda, torch.float32, B, Cout, std=0.1)
        res = _rand(g, cuda, dt, B, H, W, Cout) if with_res else None
        w9 = K8.pack_weight(w, dt)
        got = K8.launch_conv3x3(x, a, b, w9, bias, row, res)
        _gpu_close(got, K8.conv3x3_plain(x, a, b, w, bias, row, res), dt)
        assert torch.equal(got, K8.launch_conv3x3(x, a, b, w9, bias, row, res))
        ones, zeros = torch.ones_like(a), torch.zeros_like(b)
        _gpu_close(K8.launch_conv3x3(x, ones, zeros, w9, bias, row, None, "none"),
                   K8.conv3x3_plain(x, ones, zeros, w, bias, row, None, "none"), dt)


# (M, N, K, epilogue): every K of the main path (256, 320, 512, 640, 1280,
# 2560, 5120) with the epilogue it takes there, then ragged shapes: M not a
# multiple of the 128-row tile, N not a multiple of the tile width (160 or
# 128), K not a multiple of the 64-deep stage and below it
GEMM_CASES = [
    (2048, 320, 320, dict(res1=True, res2_div=1024, steps=True)),  # 32^2 out-proj, attn2 a row an image
    (2048, 960, 320, dict(bias=False)),  # 32^2 qkv
    (2048, 2560, 320, dict(act="geglu", steps=True)),
    (2048, 320, 1280, dict(res1=True, steps=True)),  # FF out
    (1024, 640, 640, dict(res1=True, res2_div=1, steps=True)),  # 16^2 out-proj, attn2 a map
    (1024, 5120, 640, dict(act="geglu", steps=True)),
    (1024, 640, 2560, dict(res1=True, steps=True)),
    (512, 1280, 5120, dict(res1=True)),  # the big-C form's FF: one rounding
    (4096, 768, 256, dict(out="f32")),  # the DiT's qkv
    (4096, 256, 256, dict(gate=True, alias=True)),  # gated in-place residual on the fp32 stream
    (4096, 512, 256, dict(act="gelu")),
    (4096, 256, 512, dict(gate=True, alias=True)),
    (1000, 200, 72, dict(act="gelu", res1=True)),
    (300, 96, 40, dict(res1=True, res2_div=100, steps=True)),
    (777, 192, 136, dict(act="geglu", res1=True, steps=True)),
    (130, 320, 320, dict(act="geglu", gate=True)),  # GEGLU without steps
    (257, 160, 264, dict(out="f32", res1=True, res2_div=1)),  # fp32 out, bf16 residuals
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,epi", GEMM_CASES, ids=[f"{m}x{n}x{k}" for m, n, k, _ in GEMM_CASES])
def test_gpu_gemm_sm90_matches_plain(cuda, M, N, K, epi):
    """The wgmma site GEMM against gemm_plain (the fp32 product and the
    TPU kernels' epilogue with their rounding points) on bf16 operands, each
    epilogue on its route; `out` aliasing `res1` where the DiT updates its
    stream in place. Two runs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(9)
    bf = torch.bfloat16
    act = {"geglu": K3.ACT_GEGLU, "gelu": K3.ACT_GELU}.get(epi.get("act"), K3.ACT_NONE)
    assert K3.gemm_route(bf, N, K, act) == "sm90"
    n_out = N // 2 if act == K3.ACT_GEGLU else N
    out_dt = torch.float32 if epi.get("out") == "f32" or epi.get("alias") else bf
    a, w = _rand(g, cuda, bf, M, K), _rand(g, cuda, bf, N, K, std=K**-0.5)
    kw = dict(act=act, steps=epi.get("steps", False), out_dtype=out_dt,
              bias=_rand(g, cuda, torch.float32, N, std=0.1) if epi.get("bias", True) else None,
              gate=_rand(g, cuda, torch.float32, n_out, std=0.5) if epi.get("gate") else None)
    res_dt = torch.float32 if epi.get("alias") else bf
    res1 = _rand(g, cuda, res_dt, M, n_out) if epi.get("res1") or epi.get("alias") else None
    if "res2_div" in epi:
        kw.update(res2=_rand(g, cuda, bf, M // epi["res2_div"], n_out), res2_div=epi["res2_div"])

    def run(fn):
        r = None if res1 is None else res1.clone()
        return fn(a, w, res1=r, out=r if epi.get("alias") else None, **kw)

    got, want = run(K3.gemm), run(K3.gemm_plain)
    assert got.shape == (M, n_out) and got.dtype == out_dt
    if out_dt == bf:
        _close_ulp(got, want)
    else:
        _gpu_close(got, want, torch.float32)
    assert torch.equal(got, run(K3.gemm))


@pytest.mark.gpu
def test_gpu_gemm_routes_and_prepared_site(cuda):
    """Each route counts under its own name, the prepared weights' tensor
    maps are made once, and K3 on prepared weights gives the bits it gives on
    the raw ones."""
    from mvdfusion_tpu_torch.ops import _lib

    g = torch.Generator(device=cuda).manual_seed(10)
    bf = torch.bfloat16
    a, w = _rand(g, cuda, bf, 256, 320), _rand(g, cuda, bf, 320, 320, std=320**-0.5)
    _lib.reset_launches()
    sm90, wmma = K3.gemm(a, w), K3.gemm(a, w, route="wmma")
    K3.gemm(a.float(), w.float())
    assert dict(_lib.LAUNCHES) == {"gemm_sm90": 1, "gemm_wmma": 1, "gemm_f32": 1}
    _close_ulp(wmma, sm90)
    B, N, C, heads = 2, 256, 320, 8
    raw = _site_weights(g, cuda, bf, C)
    x, a2 = _rand(g, cuda, bf, B, N, C), _rand(g, cuda, bf, B, C)
    prepared = K3.prepare_site_weights(raw, bf)
    first = K3.launch_transformer_block(x, a2, prepared, heads)
    maps = {f: getattr(prepared, f)._mvdf_tma[1] for f in ("pi_w", "qkv_w", "out_w", "g_w", "f_w", "po_w")}
    assert torch.equal(first, K3.launch_transformer_block(x, a2, prepared, heads))
    assert all(getattr(prepared, f)._mvdf_tma[1] is m for f, m in maps.items())
    assert torch.equal(first, K3.launch_transformer_block(x, a2, raw, heads))


@pytest.mark.gpu
def test_gpu_loaded_file_reaches_the_cached_site_weights(cuda, tmp_path):
    """A transformer site at the flagship's 32^2 shape runs K3 once, so its
    prepared weights are cached; then a file of another site's weights
    loads into it through convert/reference.py. Its next output equals the
    other site's bit for bit (the copy moved the versions the cache is
    keyed on) and differs from its first."""
    from mvdfusion_tpu_torch.convert import reference as P
    from mvdfusion_tpu_torch.nn.layers import GroupNorm32, LayerNormFp32
    from mvdfusion_tpu_torch.nn.unet import SpatialTransformer
    from mvdfusion_tpu_torch.nn.viewfusion import randomize_
    from mvdfusion_tpu_torch.ops import _lib

    C, heads, ctx = 320, 8, 768

    def site(seed):
        m = randomize_(SpatialTransformer(C, heads, C // heads, 1, ctx).to(cuda), seed)
        for mod in m.modules():  # the model's compute dtypes: norms in fp32, the rest in bf16
            if not isinstance(mod, (GroupNorm32, LayerNormFp32)):
                for p in mod.parameters(recurse=False):
                    p.data = p.data.to(torch.bfloat16)
        return m.eval()

    g = torch.Generator(device=cuda).manual_seed(11)
    x, context = _rand(g, cuda, torch.bfloat16, 2, 32, 32, C), _rand(g, cuda, torch.bfloat16, 2, 1, ctx)
    a, b = site(0), site(1)
    with torch.no_grad():
        _lib.reset_launches()
        first = a(x, context)
        assert _lib.LAUNCHES["transformer_block"] == 1
        path = str(tmp_path / "site.pt")
        torch.save(b.state_dict(), path)
        stats = P.load_state(a, P.load_torch_state(path), verbose=False)
        assert stats.missing == [] and stats.unused == [] and len(stats.written) == len(b.state_dict())
        after, want = a(x, context), b(x, context)
    assert _lib.LAUNCHES["transformer_block"] == 3
    assert torch.equal(after, want) and not torch.equal(after, first)


def _gridattn_call(dev, V, seed, overwrite, sched):
    """GridAttn.forward's arguments at the published widths for V target
    views of 32^2 latents (the sampler's: fp32 latents, t_embed of 256, the
    DDPM tables `sched`), from `seed`."""
    import numpy as np

    from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform, make_cameras

    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=dev)
    R, T = look_at_view_transform(dist=1.5, elev=10.0 + seed, azim=np.linspace(0, 360, V + 1)[:-1] + 7 * seed)
    cams = make_cameras(R, T, 2.1875, device=dev)
    R0, T0 = look_at_view_transform(dist=1.5, elev=20.0, azim=np.array([3.0 * seed]))
    t = torch.full((V,), 100 + 37 * seed, dtype=torch.long, device=dev)
    return (r(V, 32, 32, 5), cams, torch.ones(V, device=dev), r(V, 256), t, sched,
            r(1, 32, 32, 5), make_cameras(R0, T0, 2.1875, device=dev), r(V, 32, 32, 1),
            r(V, 32, 32, 1) if overwrite else None)


@pytest.mark.gpu
@pytest.mark.parametrize("overwrite", [False, True], ids=["estimate", "overwrite"])
@pytest.mark.parametrize("V,route", [(8, "single"), (15, "two_phase")])
def test_gpu_gridattn_graph_replays_bit_equal_to_the_eager_body(cuda, V, route, overwrite):
    """GridAttn at the published widths in bf16 (K4 at V=8, K4b at V=15):
    the capturing call, a replay on another pass's cameras, latents, t and
    jitter (a value baked into the graph would show), a second scene's
    replay before the first's output is read (an output the next replay
    overwrote would show), and, after a weight reload, a new capture (stale
    prepared weights would show): each bit-equal to eager_forward on the
    same inputs. The replays count their kernels in _lib.REPLAYED, none in
    LAUNCHES; under autograd forward takes the eager body."""
    from mvdfusion_tpu_torch.core.schedule import make_ddpm_schedule
    from mvdfusion_tpu_torch.nn.viewattn import GridAttn
    from mvdfusion_tpu_torch.ops import _lib
    from mvdfusion_tpu_torch.utils import trace

    assert K4.crossview_route(V, 32, 32, 256, torch.bfloat16) == route
    m = GridAttn(hidden_size=256, output_dim=768, num_heads=8, num_layers=3).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(V)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=cuda) * (p.shape[-1] ** -0.5 if p.ndim == 2 else 0.1))
    m.to(torch.bfloat16)
    sched = make_ddpm_schedule(device=cuda)  # one table, as the model keeps one a device: its pointers are keyed
    calls = [_gridattn_call(cuda, V, s, overwrite, sched) for s in range(3)]
    key = "crossview_two_phase" if route == "two_phase" else "crossview"
    trace.clear()
    _lib.reset_launches()
    with torch.no_grad():
        got = [m(*a) for a in calls]  # capture, then two replays, none read before the last
        host = _lib.LAUNCHES[key]
        want = [m.eager_forward(*a) for a in calls]
        assert host == 0 and _lib.REPLAYED["LAUNCHES"][key] == 3 and _lib.LAUNCHES[key] == 3
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert not torch.equal(got[0], got[1])
        for p in m.parameters():  # a weight reload: the copy moves every parameter's version
            p.copy_(p * 0.5)
        again = m(*calls[0])
        assert torch.equal(again, m.eager_forward(*calls[0])) and not torch.equal(again, got[0])
        assert len(m._graphs) == 1
    with torch.enable_grad():
        m(*calls[1])
    names = [r.name for r in trace.records()]
    assert names == ["gridattn.capture", "gridattn.replay", "gridattn.replay", "gridattn.capture"]


@pytest.mark.gpu
def test_gpu_a_sampler_step_neither_synchronises_nor_copies_from_the_host(cuda, tmp_path):
    """A profiled pass of the tiny configuration after one that captured
    GridAttn's graph: no cudaStreamSynchronize, cudaDeviceSynchronize or
    cudaMemcpy inside any `mvdf.sample.step`, and no cudaMemcpyAsync there
    that copies from or to the host (read from the copy its correlation id
    names, where the trace kept it); GridAttn replays its graph
    (cudaGraphLaunch) at every call."""
    import json

    import numpy as np

    from mvdfusion_tpu_torch.geometry.cameras import look_at_view_transform
    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
    from mvdfusion_tpu_torch.pipeline.sampler import ddim_sample_scenes
    from mvdfusion_tpu_torch.utils import trace
    from torch.profiler import ProfilerActivity, profile

    N, S, views = 2, 4, 4
    with torch.no_grad():
        model = randomize_(ViewFusion(ViewFusionConfig().tiny(), device=cuda), seed=0).eval()
        R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, views) + 90)
        idx = torch.tensor([0], device=cuda), torch.arange(1, views, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(1)
        prepared = [model.prepare_batch(torch.rand(views, 64, 64, 3, generator=g, device=cuda),
                                        torch.as_tensor(R, device=cuda), torch.as_tensor(T, device=cuda),
                                        torch.full((views, 2), 2.1875, device=cuda),
                                        torch.zeros(views, 2, device=cuda), *idx) for _ in range(N)]
        _, cams, in_lat, in_cams, clip_v = zip(*prepared)
        run = lambda: ddim_sample_scenes(model, cams, in_lat, in_cams, torch.stack(clip_v), 2.5, num_steps=S)
        run()
        torch.cuda.synchronize()
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    steps = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == "mvdf.sample.step"]
    assert len(steps) == S
    inside = lambda e: any(a <= e["ts"] <= b for a, b in steps)
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and inside(e)]
    copies = {e["args"].get("correlation"): e["name"] for e in events if e.get("cat") == "gpu_memcpy"}
    names = [e["name"] for e in runtime]
    assert not {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"} & set(names), sorted(set(names))
    host_copies = [copies.get(e["args"].get("correlation")) for e in runtime if e["name"] == "cudaMemcpyAsync"]
    assert not [c for c in host_copies if c and ("HtoD" in c or "DtoH" in c)], host_copies
    assert names.count("cudaGraphLaunch") == N * S
    spans = [r.name for r in trace.records() if r.name.startswith("gridattn.")]
    assert spans == ["gridattn.replay"] * (N * S)
