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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gpu_k3_kernel_matches_plain(cuda, dt):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, N, C, heads = 2, 256, 320, 8
    lin = lambda o, i: _rand(g, cuda, dt, o, i, std=i**-0.5)
    vec = lambda n: _rand(g, cuda, torch.float32, n, std=0.1)
    w = K3.BlockWeights(
        gn_w=1 + vec(C), gn_b=vec(C), pi_w=lin(C, C), pi_b=vec(C), ln1_w=1 + vec(C), ln1_b=vec(C),
        qkv_w=lin(3 * C, C), out_w=lin(C, C), out_b=vec(C), ln3_w=1 + vec(C), ln3_b=vec(C),
        g_w=lin(8 * C, C), g_b=vec(8 * C), f_w=lin(C, 4 * C), f_b=vec(C), po_w=lin(C, C), po_b=vec(C))
    x = _rand(g, cuda, dt, B, N, C)
    for a2 in (_rand(g, cuda, dt, B, C), _rand(g, cuda, dt, B, N, C)):
        _gpu_close(K3.launch_transformer_block(x, a2, w, heads), K3.transformer_block_plain(x, a2, w, heads), dt)


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
