"""The modules that hold the port's four kernels (K1 GroupNorm, K2 attention,
K3 transformer site, K4 cross-view aggregation) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do. Same
numpy inputs and weights on both sides, fp32. Tolerance 1e-4 max-abs: the
same math with reductions in a different order (up to a few hundred terms).
The CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_port_gpu.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.convert import mapping as jmap
from mvdfusion_tpu.core.schedule import make_ddpm_schedule as jddpm
from mvdfusion_tpu.geometry.cameras import look_at_view_transform, make_cameras as jmake
from mvdfusion_tpu.nn.unet import SpatialTransformer as JSpatial
from mvdfusion_tpu.nn.unet import ViewAlignedFeatureTransformer as JViewAligned
from mvdfusion_tpu.nn.viewattn import GridAttn as JGridAttn
import mvdfusion_tpu.ops.attention as ja
from mvdfusion_tpu.ops.attention import fused_attention as j_attention
from mvdfusion_tpu.ops.groupnorm import group_norm_act as j_group_norm
from mvdfusion_tpu_torch.core.schedule import make_ddpm_schedule
from mvdfusion_tpu_torch.geometry.cameras import make_cameras
from mvdfusion_tpu_torch.nn.unet import SpatialTransformer, ViewAlignedFeatureTransformer
from mvdfusion_tpu_torch.nn.viewattn import GridAttn
from mvdfusion_tpu_torch.nn.viewfusion import randomize_
from mvdfusion_tpu_torch.ops import attention as K2
from mvdfusion_tpu_torch.ops import block as K3
from mvdfusion_tpu_torch.ops import crossview as K4
from mvdfusion_tpu_torch.ops import groupnorm as K1

TOL = 1e-4


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol, f"max|diff| {err:.3e} > {tol:g}"


def T(a):
    return torch.as_tensor(np.asarray(a))


def flax_params(module, table):
    """The port module's state dict as flax params, through the JAX package's
    mapping table and TRANSFORMS (table keys may start with '.')."""
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    tree = {}
    for fpath, (tkey, tf) in table.items():
        d = tree
        for p in fpath[:-1]:
            d = d.setdefault(p, {})
        d[fpath[-1]] = jnp.asarray(jmap.TRANSFORMS[tf](sd[tkey.lstrip(".")]).astype(np.float32))
    return {"params": tree}


# ----------------------------------------------------------------- K1, K2
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("N,C", [(96, 64), (16, 320)])
def test_k1_group_norm_matches_pallas(rng, act, eps, N, C):
    """Also a 4^2-like map at C=320: cg = 10 channels a group, so a 16-byte
    bf16 vector of 8 channels straddles two groups on the card."""
    x = (rng.normal(size=(2, N, C)) * 3 + 1).astype(np.float32)
    g, b = (1 + 0.1 * rng.normal(size=C)).astype(np.float32), (0.1 * rng.normal(size=C)).astype(np.float32)
    ref = j_group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 32, eps, act, True)
    close(K1.group_norm_act(T(x), T(g), T(b), 32, eps, act), ref)


@pytest.mark.parametrize("shape", [(1, 257, 2, 64), (2, 256, 1, 512)])
def test_k2_attention_matches_pallas(rng, shape):
    """CLIP's ragged 257 tokens and the VAE's single dh=512 head."""
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    ref = j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True)
    close(K2.fused_attention(T(q), T(k), T(v), scale), ref)


@pytest.mark.parametrize("shape,form", [
    ((1, 257, 2, 64), "natural pv"),  # CLIP's ragged 257 tokens
    ((2, 256, 2, 40), "transposed pv"),  # a 32^2-site head
    ((1, 256, 1, 512), "natural probs"),  # the VAE's lane-aligned dh=512 head
])
def test_k2_bf16_matches_pallas(rng, monkeypatch, shape, form):
    """K2's plain version in bf16 against the reference's kernel in each of its
    rounding forms (interpret mode, compiled without XLA's excess precision,
    which would drop the bf16 roundings inside the kernel body): 1 bf16 ulp
    of max|ref|, mean 1e-4 x max|ref|."""
    for var in ("MVDF_ATTN_NORM", "MVDF_ATTN_T"):
        monkeypatch.delenv(var, raising=False)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    f = jax.jit(lambda q, k, v: ja._fused_attention_fwd_impl(q, k, v, scale, True))
    ref = np.asarray(f.lower(jq, jk, jv).compile(compiler_options={"xla_allow_excess_precision": False})(
        jq, jk, jv).astype(jnp.float32))
    out = K2.fused_attention(*(T(a).to(torch.bfloat16) for a in (q, k, v)), scale).float().numpy()
    top = np.abs(ref).max()
    err = np.abs(out - ref)
    assert err.max() <= 2.0 ** (np.floor(np.log2(top)) - 7), f"{form}: max|diff| {err.max():.3e}"
    assert err.mean() <= 1e-4 * top, f"{form}: mean|diff| {err.mean():.3e}"


@pytest.mark.parametrize("dh", [40, 64, 80, 128, 512])
def test_k2_plain_mode_follows_ones_free(monkeypatch, dh):
    """attention_plain's default form is the one the reference's natural
    orientation traces at this dh (its ones_free test): _attn_kernel (pv) or
    _attn_kernel_probs."""
    monkeypatch.setenv("MVDF_ATTN_T", "0")
    monkeypatch.delenv("MVDF_ATTN_NORM", raising=False)
    traced = []
    for name in ("_attn_kernel", "_attn_kernel_probs"):
        real = getattr(ja, name)
        monkeypatch.setattr(ja, name, lambda *a, _n=name, _f=real, **kw: (traced.append(_n), _f(*a, **kw))[1])
    x = jnp.zeros((1, 8, 1, dh), jnp.float32)
    jax.make_jaxpr(lambda q: ja._fused_attention_fwd_impl(q, q, q, 1.0, True))(x)
    want = K2.MODE_PV if traced == ["_attn_kernel"] else K2.MODE_PROBS
    assert traced in (["_attn_kernel"], ["_attn_kernel_probs"]), traced
    assert K2.attention_mode(dh) == want
    q, k, v = (torch.randn(1, 9, 2, dh, generator=torch.Generator().manual_seed(i)).to(torch.bfloat16)
               for i in range(3))
    assert torch.equal(K2.attention_plain(q, k, v, dh**-0.5), K2.attention_plain(q, k, v, dh**-0.5, want))


# --------------------------------------------------------------------- K3
@pytest.mark.parametrize("H", [16, 8])
def test_k3_spatial_transformer_site_matches(rng, H):
    """H=16 (N=256) takes the kernel site in both packages (the JAX side in
    interpret mode); H=8 stays on the plain module path in both."""
    B, C, heads, ctx_dim = 2, 32, 4, 48
    m = randomize_(SpatialTransformer(C, heads, C // heads, 1, ctx_dim), seed=1)
    assert K3.should_fuse_block(C, H * H, heads) == (H == 16)
    table = {}
    jmap._spatial_transformer(table, (), "", 1)
    x = rng.normal(size=(B, H, H, C)).astype(np.float32)
    ctx = rng.normal(size=(B, 1, ctx_dim)).astype(np.float32)
    jm = JSpatial(heads, C // heads, fuse_mode="interpret" if H == 16 else "never")
    ref = jm.apply(flax_params(m, table), jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        close(m(T(x), T(ctx)), ref)


def test_k3_view_aligned_site_matches(rng):
    """The grafted site: the attn2 term is a per-pixel (B, N, C) map."""
    B, H, C, heads, ctx_dim = 2, 16, 32, 4, 48
    m = randomize_(ViewAlignedFeatureTransformer(C, heads, C // heads, 1, ctx_dim), seed=2)
    table = {}
    jmap._view_aligned_transformer(table, (), "", 1)
    x = rng.normal(size=(B, H, H, C)).astype(np.float32)
    vol = rng.normal(size=(B, H, H, 1, ctx_dim)).astype(np.float32)
    ref = JViewAligned(heads, C // heads, fuse_mode="interpret").apply(
        flax_params(m, table), jnp.asarray(x), jnp.asarray(vol))
    with torch.no_grad():
        close(m(T(x), T(vol)), ref)


# --------------------------------------------------------------------- K4
@dataclasses.dataclass(frozen=True)
class _ViewattnCfg:
    viewattn_layers: int = 2


@pytest.mark.parametrize("V,H,D", [(3, 8, 1), (4, 8, 2)])
def test_k4_gridattn_matches_pallas(rng, V, H, D):
    """GridAttn end to end (depth unbias + jitter, rays, reprojection, the
    factorised projector, the kall repack, DiT, pool) with shared jitter
    noise, against the JAX module running its crossview kernel in interpret
    mode."""
    hidden, heads, layers, out_dim = 32, 4, 2, 48
    m = randomize_(GridAttn(hidden_size=hidden, output_dim=out_dim, num_heads=heads,
                            num_layers=layers, n_pts_per_ray=D), seed=3)
    params = flax_params(m, jmap.viewattn_mapping(_ViewattnCfg(layers)))
    R, Tr = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 360 * (V - 1) / V, V) + 90)
    f, c = np.full((V, 2), 2.1875, np.float32), np.zeros((V, 2), np.float32)
    noisy = (rng.normal(size=(V, H, H, 5)) * 0.5).astype(np.float32)
    in_lat = (rng.normal(size=(1, H, H, 5)) * 0.5).astype(np.float32)
    t_embed = rng.normal(size=(V, hidden)).astype(np.float32)
    jitter = rng.normal(size=(V, H, H, D)).astype(np.float32)
    t = np.full((V,), 500, np.int32)
    jm = JGridAttn(hidden_size=hidden, output_dim=out_dim, num_heads=heads, num_layers=layers,
                   n_pts_per_ray=D, crossview_kernel="interpret")
    ref = jm.apply(params, jnp.asarray(noisy), jmake(R, Tr, f, c), jnp.ones((V,)), jnp.asarray(t_embed),
                   jnp.asarray(t), jddpm(1000), jnp.asarray(in_lat), jmake(R[:1], Tr[:1], f[:1], c[:1]),
                   jax.random.PRNGKey(0), jitter_noise=jnp.asarray(jitter))
    with torch.no_grad():
        out = m(T(noisy), make_cameras(R, Tr, f, c), torch.ones(V), T(t_embed), T(t).long(), make_ddpm_schedule(),
                T(in_lat), make_cameras(R[:1], Tr[:1], f[:1], c[:1]), T(jitter))
    assert tuple(out.shape) == (V, H, H, D, out_dim)
    close(out, ref)
