"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test decides inside its fixture whether there is a card
and skips without one. This file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q --noconftest

Tolerance: max|kernel - plain| <= tol x max(1, max|plain|), tol 1e-4 in fp32
(the same math in another sum order) and 3e-2 in bf16 (roundings at other
points of chained bf16 products). TF32 is off for the plain versions.
"""

import pytest
import torch

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
    (N=96: partial GEMM and attention tiles), attn2 row and map."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for B, N, C, heads in ((2, 1024, 320, 8), (3, 96, 64, 4)):
        w = _site_weights(g, cuda, dt, C)
        x = _rand(g, cuda, dt, B, N, C)
        for a2 in (_rand(g, cuda, dt, B, C), _rand(g, cuda, dt, B, N, C)):
            _gpu_close(K3.launch_transformer_block_single(x, a2, w, heads),
                       K3.transformer_block_plain(x, a2, w, heads), dt)


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


def _k4_inputs(g, dev, dt, V, Hh, hid, L, heads, out_dim, nh=7):
    mlp, N, G = 2 * hid, V * Hh * Hh, 7 * (1 + 2 * nh)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k4_kernel_matches_plain(cuda, dt):
    g = torch.Generator(device=cuda).manual_seed(2)
    args = _k4_inputs(g, cuda, dt, V=4, Hh=16, hid=256, L=2, heads=8, out_dim=96)
    _gpu_close(K4.launch_crossview(*args), K4.crossview_plain(*args), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,shape", [
    (torch.float32, dict(V=3, Hh=8, hid=64, L=2, heads=4, out_dim=48)),
    (torch.bfloat16, dict(V=15, Hh=32, hid=256, L=3, heads=8, out_dim=768)),  # the 15-view evaluation
])
def test_gpu_k4_two_phase_matches_plain(cuda, dt, shape):
    """The two-phase form: phase-1 tokens within 1 bf16 ulp of the plain
    tokens rounded to bf16 plus the bound on the two fp32 sums' difference
    (crossview.gather_tokens_bound; 1e-4 in fp32), and the output within
    GPU_TOL."""
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
    _gpu_close(K4.launch_crossview_two_phase(*args), K4.crossview_two_phase_plain(*args), dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k7_groupnorm_tiled_matches_plain(cuda, dt):
    """The tiled GroupNorm's stats pass with its fold (a ragged last row tile
    at N=3000; the eval path's B=7 chunk; 8 groups of 5 channels at C=40)
    and the apply pass (8 and 4 elements a thread at C = 96 and 128, one at
    C = 40), and gn_fold_affine's unclamped fold. The stats pass adds its
    partials in a fixed order: two runs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(6)
    for shape in ((2, 3000, 96), (7, 4096, 128), (3, 700, 40)):
        x = _rand(g, cuda, dt, *shape, std=3.0) + 1
        w, b = 1 + _rand(g, cuda, torch.float32, shape[-1], std=0.1), _rand(g, cuda, torch.float32, shape[-1], std=0.1)
        groups = 8 if shape[-1] == 40 else 32
        for act in ("none", "silu"):
            _gpu_close(K1.launch_group_norm_tiled(x, w, b, groups, 1e-6, act),
                       K1.group_norm_tiled_plain(x, w, b, groups, 1e-6, act), dt)
        (ka, kb), (pa, pb) = K8.launch_gn_fold_affine(x, w, b, groups, 1e-6), K8.gn_fold_affine_plain(x, w, b, groups, 1e-6)
        _gpu_close(ka, pa, torch.float32)
        _gpu_close(kb, pb, torch.float32)
        _gpu_close(K1.launch_apply_affine(x, pa, pb, "silu"), K1.apply_affine_plain(x, pa, pb, "silu"), dt)
        first, again = K1.launch_fold(x, w, b, groups, 1e-6, True), K1.launch_fold(x, w, b, groups, 1e-6, True)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k8_conv3x3_matches_plain(cuda, dt):
    """The fused GN-affine + SiLU + conv at edge shapes: H not a multiple of
    the row tile (TX 32 x TR 4 over H=21; TX 16 x TR 8 over H=9), W not a
    multiple of the column tile (136 over TX 128), the B=7 chunk, Cin below
    one 32-channel slice, Cout not a multiple of the 64-channel tile, with and
    without a residual, and act="none" with the identity affine."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for B, H, W, Cin, Cout, with_res in ((2, 21, 40, 32, 64, True), (7, 19, 64, 128, 128, True),
                                         (1, 9, 136, 64, 8, False), (2, 9, 16, 16, 24, True)):
        x = _rand(g, cuda, dt, B, H, W, Cin)
        a, b = 1 + _rand(g, cuda, torch.float32, B, Cin, std=0.3), _rand(g, cuda, torch.float32, B, Cin, std=0.2)
        w = _rand(g, cuda, dt, Cout, Cin, 3, 3, std=(9 * Cin) ** -0.5)
        bias, row = _rand(g, cuda, torch.float32, Cout, std=0.1), _rand(g, cuda, torch.float32, B, Cout, std=0.1)
        res = _rand(g, cuda, dt, B, H, W, Cout) if with_res else None
        w9 = K8.pack_weight(w, dt)
        _gpu_close(K8.launch_conv3x3(x, a, b, w9, bias, row, res), K8.conv3x3_plain(x, a, b, w, bias, row, res), dt)
        ones, zeros = torch.ones_like(a), torch.zeros_like(b)
        _gpu_close(K8.launch_conv3x3(x, ones, zeros, w9, bias, row, None, "none"),
                   K8.conv3x3_plain(x, ones, zeros, w, bias, row, None, "none"), dt)
