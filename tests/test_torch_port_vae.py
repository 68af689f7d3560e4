"""The VAE's switched forms against the JAX package: the tiled GroupNorm (K7,
MVDF_GN_TILED=1), the folded-GN statistics and the fused GN-affine + SiLU +
3x3 conv (K8, MVDF_CONV3X3=1), their gates, the ResBlock's fused branch and
one tiny encode + decode with both switches on; and K1 in bf16.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, compiled with XLA's excess precision
off (as tests/test_torch_port_blockforms.py does: otherwise XLA on the CPU
drops the bf16 roundings inside an interpret-mode kernel body). The
reference's gates ask for a TPU backend: where a test needs the reference's
own gate, it is asked with jax.default_backend patched for the call. Module
globals (_MAX_SLICE_ELEMS, _TILE_ELEMS) are shrunk on both sides, as
tests/test_ops_block.py does with its budgets, so that small maps take
several tiles. Same numpy inputs and weights on both sides.

Tolerances: fp32 1e-5 (K7, the fold) and 2e-5 (the conv, as
tests/test_ops_conv3x3.py holds the reference's kernel to its twin),
max-abs; bf16 1 bf16 ulp of max|ref| and a mean of 1e-4 x max|ref| (both
sides round at the same points, so only a rounding split by an fp32 sum
order remains); the tiny encode + decode 1e-4 x max|ref|.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.ops.conv3x3 as jc3
import mvdfusion_tpu.ops.groupnorm as jgn
from mvdfusion_tpu.convert import mapping as jmap
from mvdfusion_tpu.nn.vae import VAEResnetBlock as JVAEResnetBlock
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu_torch.nn.vae import VAEResnetBlock
from mvdfusion_tpu_torch.nn.viewfusion import randomize_
from mvdfusion_tpu_torch.ops import conv3x3 as C3
from mvdfusion_tpu_torch.ops import groupnorm as K
from test_torch_port_kernels import flax_params
from test_torch_port_model import nest, pair, rel_close  # noqa: F401 (pair is a fixture)

BF = torch.bfloat16
NO_EXCESS = {"xla_allow_excess_precision": False}
SWITCHES = ("MVDF_GN_TILED", "MVDF_CONV3X3")
# the unpatched functions, for wrappers that count calls or change a backend
_REAL_GN_GATE = jgn.should_fuse_gn
_REAL_CONV_GATE = jc3.should_fuse_conv3x3
_TILED_PLAIN = K.group_norm_tiled_plain
_CONV_PLAIN = C3.conv3x3_plain


def _jit(f, *args):
    """f(*args) under jax.jit with XLA's excess precision off, as fp32 numpy."""
    out = jax.jit(f).lower(*args).compile(compiler_options=NO_EXCESS)(*args)
    return jax.tree_util.tree_map(lambda o: np.asarray(o.astype(jnp.float32)), out)


def _J(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF else jnp.float32)


def bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def _check(out, ref, dt, tol):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref)
    if dt == torch.float32:
        assert err.max() <= tol, f"max|diff| {err.max():.3e} > {tol:g}"
        return
    scale = np.abs(ref).max()
    assert err.max() <= bf16_ulp(scale), f"max|diff| {err.max():.3e} vs bf16 ulp {bf16_ulp(scale):.3e}"
    assert err.mean() <= 1e-4 * scale, f"mean|diff| {err.mean():.3e} vs max|ref| {scale:.3e}"


@contextlib.contextmanager
def _tpu_backend():
    """jax.default_backend() answers "tpu" inside, for asking the reference's
    gates as on their own hardware; nothing is computed inside."""
    real = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        yield
    finally:
        jax.default_backend = real


def _ref_gn_gate(shape, groups):
    with _tpu_backend():
        return _REAL_GN_GATE(shape, groups)


def _ref_conv_gate(shape, groups=32):
    with _tpu_backend():
        return _REAL_CONV_GATE(shape, groups)




def _set_switches(monkeypatch, gn_tiled, conv):
    monkeypatch.delenv("MVDF_DISABLE_PALLAS", raising=False)
    for var, on in zip(SWITCHES, (gn_tiled, conv)):
        if on:
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)


@pytest.fixture
def small_tiles(monkeypatch):
    """The tiled form from 2^12 elements an image with tiles of 2^11, on both sides."""
    for mod in (jgn, K):
        monkeypatch.setattr(mod, "_MAX_SLICE_ELEMS", 1 << 12)
        monkeypatch.setattr(mod, "_TILE_ELEMS", 1 << 11)
    return monkeypatch


@pytest.fixture
def interpret_ref(monkeypatch):
    """The reference's VAE calls its kernels without `interpret`: force it,
    as tests/test_ops_conv3x3.py does."""
    real_gn, real_conv, real_fold = jgn.group_norm_act, jc3.gn_silu_conv3x3, jc3.gn_fold_affine
    monkeypatch.setattr(jgn, "group_norm_act",
                        lambda x, s, b, g, eps, act="none", interpret=False: real_gn(x, s, b, g, eps, act, True))
    monkeypatch.setattr(jc3, "gn_silu_conv3x3",
                        lambda x, a, b, w, bias, row, res, act="silu", interpret=False:
                        real_conv(x, a, b, w, bias, row, res, act, True))
    monkeypatch.setattr(jc3, "gn_fold_affine",
                        lambda x, s, bb, g, eps, interpret=False: real_fold(x, s, bb, g, eps, True))


# --------------------------------------------------------------------- K7
@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_k7_tiled_groupnorm_matches_pallas(small_tiles, dt, act):
    """The tiled form's plain version against _gn_tiled_impl (_gn_stats_kernel
    over 8 row tiles + the fold + _gn_apply_kernel) in interpret mode, through
    both packages' dispatch. Measured on the CPU: fp32 max|diff| <= 1.2e-6;
    bf16 <= 0.07 ulp, mean <= 2.7e-8 x max|ref|."""
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.normal(size=(2, 256, 64)) * 3 + 1).astype(np.float32)).to(dt)
    g = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    b = (0.1 * rng.normal(size=64)).astype(np.float32)
    assert K._pick_tile(256, 64) == jgn._pick_tile(256, 64) == 32
    ref = _jit(lambda x, g, b: jgn.group_norm_act(x, g, b, 32, 1e-6, act, True), _J(x), jnp.asarray(g), jnp.asarray(b))
    calls = []
    small_tiles.setattr(K, "group_norm_tiled_plain", lambda *a: calls.append(1) or _TILED_PLAIN(*a))
    out = K.group_norm_act(x, torch.tensor(g), torch.tensor(b), 32, 1e-6, act)
    assert calls == [1]
    _check(out, ref, dt, 1e-5)



def test_k7_dispatch_without_a_tile_takes_the_plain_version(small_tiles):
    """Above the slice budget with no tile (N = 100 rows halve to 25, not a
    multiple of 8) the reference computes its XLA twin, and so does the port."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(1, 100, 64)) * 2).astype(np.float32)
    g, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    assert K._pick_tile(100, 64) is None and jgn._pick_tile(100, 64) is None
    ref = _jit(lambda x: jgn.group_norm_act(x, jnp.asarray(g), jnp.asarray(b), 32, 1e-6, "silu", True), jnp.asarray(x))
    _check(K.group_norm_act(torch.tensor(x), torch.tensor(g), torch.tensor(b), 32, 1e-6, "silu"), ref,
           torch.float32, 1e-5)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_gn_fold_affine_matches_reference(dt):
    """gn_fold_affine's plain version against the reference's (its stats
    kernel in interpret mode over 2 row tiles, the unclamped fold), and x*a +
    b against a direct GroupNorm. Measured on the CPU: a and b within
    1.2e-7."""
    rng = np.random.default_rng(2)
    x = torch.tensor((rng.normal(size=(2, 2048, 512)) * 1.3 + 0.2).astype(np.float32)).to(dt)
    s = (rng.normal(size=512) * 0.4 + 1).astype(np.float32)
    bb = (rng.normal(size=512) * 0.2).astype(np.float32)
    assert jgn._pick_tile(2048, 512) == 1024
    ref_a, ref_b = _jit(lambda x, s, b: jc3.gn_fold_affine(x, s, b, 32, 1e-6, True), _J(x), jnp.asarray(s),
                        jnp.asarray(bb))
    a, b = C3.gn_fold_affine(x, torch.tensor(s), torch.tensor(bb), 32, 1e-6)
    assert a.dtype == b.dtype == torch.float32
    _check(a, ref_a, torch.float32, 1e-5)
    _check(b, ref_b, torch.float32, 1e-5)
    direct = K.group_norm_plain(x.float(), torch.tensor(s), torch.tensor(bb), 32, 1e-6)
    assert (x.float() * a[:, None] + b[:, None] - direct).abs().max() <= 1e-4


def test_fold_clamps_only_for_the_tiled_groupnorm():
    """The reference's tiled GroupNorm clamps E[x^2] - mu^2 at 0
    (groupnorm.py:133), its gn_fold_affine does not (conv3x3.py:89), and the
    port's two callers of fold_affine keep that difference: sums whose fp32
    variance comes out below 0 give rsqrt(var + eps) with the negative var
    unclamped and rsqrt(eps) clamped."""
    n, s = 64, torch.ones(32)
    s1 = torch.full((1, 32), 4.0 * n)
    s2 = torch.full((1, 32), 16.0 * n - 0.5)  # E[x^2] - mu^2 = -0.5 / 64 per channel
    zeros = torch.zeros(32)
    a_conv, _ = K.fold_affine(s1, s2, s, zeros, 32, n, 1e-2, clamp=False)
    a_tiled, _ = K.fold_affine(s1, s2, s, zeros, 32, n, 1e-2, clamp=True)
    assert torch.allclose(a_conv, torch.full((1, 32), (1e-2 - 0.5 / 64) ** -0.5))
    assert torch.allclose(a_tiled, torch.full((1, 32), 1e-2 ** -0.5))
    x = torch.full((1, n, 32), 4.0)
    x[0, 0] += 1e-3
    want = C3.gn_fold_affine_plain(x, s, zeros, 32, 1e-2)[0]
    s1x, s2x = K.channel_sums_plain(x)
    assert torch.equal(want, K.fold_affine(s1x, s2x, s, zeros, 32, n, 1e-2, clamp=False)[0])


# --------------------------------------------------------------------- K8
def _conv_inputs(seed, B, H, W, Cin, Cout, dt):
    rng = np.random.default_rng(seed)
    r = lambda *s, std=1.0, mean=0.0: (rng.normal(size=s) * std + mean).astype(np.float32)
    x = torch.tensor(r(B, H, W, Cin, std=0.8, mean=0.1)).to(dt)
    a, b = torch.tensor(r(B, Cin, std=0.3, mean=1.0)), torch.tensor(r(B, Cin, std=0.2))
    w_hwio = torch.tensor(r(3, 3, Cin, Cout, std=0.05)).to(dt)
    bias, row = torch.tensor(r(Cout, std=0.1)), torch.tensor(r(B, Cout, std=0.1))
    res = torch.tensor(r(B, H, W, Cout)).to(dt)
    return x, a, b, w_hwio, bias, row, res


def _ref_conv(x, a, b, w_hwio, bias, row, res, act):
    f = lambda x, a, b, w, bias, row, *res: jc3.gn_silu_conv3x3(x, a, b, w, bias, row, res[0] if res else None, act,
                                                                 True)
    args = (_J(x), jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), _J(w_hwio), jnp.asarray(bias.numpy()),
            jnp.asarray(row.numpy())) + (() if res is None else (_J(res),))
    return _jit(f, *args)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,W,Cin,Cout", [
    (2, 16, 16, 8, 16),  # one row tile
    (1, 64, 32, 8, 8),  # the JAX test's shapes
    (2, 8, 8, 16, 8),  # a tiny single-tile map
    (1, 96, 48, 8, 8),  # several row tiles: the first, interior and last halo DMAs
    (1, 13, 24, 8, 16),  # odd H, W not a multiple of 16
])
def test_conv3x3_matches_pallas(dt, B, H, W, Cin, Cout):
    """conv3x3_plain (through gn_silu_conv3x3) against _conv_kernel in
    interpret mode, with a non-zero row and the SiLU prologue (silu(b) != 0,
    so the zero pad must follow the SiLU). Measured on the CPU: fp32 max|diff|
    <= 4.8e-7; bf16 <= 1.5e-5, far below 1 ulp, mean <= 5e-10 x max|ref|."""
    x, a, b, w, bias, row, _ = _conv_inputs(3, B, H, W, Cin, Cout, dt)
    ref = _ref_conv(x, a, b, w, bias, row, None, "silu")
    out = C3.gn_silu_conv3x3(x, a, b, w.permute(3, 2, 0, 1), bias, row, None)
    assert out.dtype == dt and tuple(out.shape) == (B, H, W, Cout)
    _check(out, ref, dt, 2e-5)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_conv3x3_residual_and_identity_prologue(dt):
    """With a residual operand; and act="none" with the identity affine (a
    plain conv + bias), as tests/test_ops_conv3x3.py checks the reference."""
    x, a, b, w, bias, row, res = _conv_inputs(4, 2, 16, 16, 8, 8, dt)
    w_oihw = w.permute(3, 2, 0, 1)
    _check(C3.gn_silu_conv3x3(x, a, b, w_oihw, bias, row, res), _ref_conv(x, a, b, w, bias, row, res, "silu"), dt,
           2e-5)
    ones, zeros, zrow = torch.ones_like(a), torch.zeros_like(b), torch.zeros_like(row)
    _check(C3.gn_silu_conv3x3(x, ones, zeros, w_oihw, bias, zrow, None, "none"),
           _ref_conv(x, ones, zeros, w, bias, zrow, None, "none"), dt, 2e-5)


def test_pack_weight_is_the_reference_tap_order():
    """The packed (9*Cin, Cout) weight is the reference's w.reshape(9*Cin,
    Cout) of the HWIO kernel in _TAPS order; it is made once per parameter."""
    assert C3._TAPS == jc3._TAPS
    w = torch.nn.Parameter(torch.randn(16, 8, 3, 3))
    hwio = w.detach().permute(2, 3, 1, 0).numpy()
    np.testing.assert_array_equal(C3.pack_weight(w, torch.float32).numpy(), hwio.reshape(72, 16))
    p1 = C3.packed_weight(w, BF)
    assert C3.packed_weight(w, BF) is p1 and p1.dtype == BF
    with torch.no_grad():
        w.mul_(2)
    assert C3.packed_weight(w, BF) is not p1


# ------------------------------------------------------------------- gates
def _vae_shapes():
    """Every VAE map shape at 256^2 (ch 128, mult 1, 2, 4, 4) for the encode
    (B=9), the decode (B=8) and the eval path's chunks (8 and 7), plus
    shapes each gate's other terms refuse."""
    shapes = [(B, r, r, C) for B in (9, 8, 7) for r in (256, 128, 64, 32) for C in (128, 256, 512)]
    return shapes + [(8, 64, 64, 320), (8, 64, 60, 128), (8, 1, 4096, 128), (8, 32, 128, 128), (8, 100, 100, 64),
                     (16, 32, 32, 320), (8, 256, 256, 130), (2, 4096, 8, 128)]


@pytest.mark.parametrize("gn_tiled", [False, True], ids=["gn_off", "gn_tiled"])
@pytest.mark.parametrize("conv", [False, True], ids=["conv_off", "conv_on"])
def test_gates_match_reference(monkeypatch, gn_tiled, conv):
    """should_fuse_gn and should_fuse_conv3x3 equal the reference's gates
    (asked as on a TPU) on every VAE shape, with either switch on or off."""
    _set_switches(monkeypatch, gn_tiled, conv)
    shapes = _vae_shapes()
    for shape in shapes:
        assert K.should_fuse_gn(shape, 32) == _ref_gn_gate(shape, 32), shape
        assert C3.should_fuse_conv3x3(shape) == _ref_conv_gate(shape), shape
    big = [s for s in shapes if s[1] * s[2] * s[3] > 1 << 20]
    assert any(K.should_fuse_gn(s, 32) for s in big) == gn_tiled
    assert any(C3.should_fuse_conv3x3(s) for s in shapes) == conv


# ---------------------------------------------------------------- ResBlock
def _block_pair(cin, cout, dt, seed):
    """A port ResBlock with random weights (convs rounded to dt) and the same
    weights as the reference's flax params."""
    m = randomize_(VAEResnetBlock(cin, cout), seed=seed).eval()
    convs = [mod for mod in (m.conv1, m.conv2, m.nin_shortcut) if mod is not None]
    for mod in convs:
        for p in (mod.weight, mod.bias):
            p.data = p.data.to(dt).float()
    table = {}
    jmap._vae_res(table, (), "", cin != cout)
    params = flax_params(m, table)
    for mod in convs:
        for p in (mod.weight, mod.bias):
            p.data = p.data.to(dt)
    return m, params


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_vae_resnet_block_fused_matches_reference(monkeypatch, interpret_ref, dt, cin, cout):
    """The ResBlock's fused branch (fold, conv1, fold, conv2 with the residual
    or nin_shortcut in its epilogue) against the reference's fused branch in
    interpret mode, the gates patched open on both sides as
    tests/test_ops_conv3x3.py does. Measured on the CPU: bf16 bit for bit.
    Before the port's 1x1 convs rounded where flax's Dense(dtype) rounds
    (the product, then the bias add), the nin_shortcut case missed: 1 ulp,
    mean 2.0e-4 x max|ref| (ROADMAP.md, Queue 3)."""
    open_gate = lambda s, groups=32: True
    monkeypatch.setattr(jc3, "should_fuse_conv3x3", open_gate)
    plain = []
    monkeypatch.setattr(C3, "should_fuse_conv3x3", open_gate)
    monkeypatch.setattr(C3, "conv3x3_plain", lambda *a: plain.append(1) or _CONV_PLAIN(*a))
    m, params = _block_pair(cin, cout, dt, seed=cout)
    x = torch.tensor((np.random.default_rng(cin + cout).normal(size=(2, 8, 8, cin)) * 0.7).astype(np.float32)).to(dt)
    jmod = JVAEResnetBlock(cout, dtype=jnp.bfloat16 if dt == BF else jnp.float32)
    ref = _jit(lambda p, x: jmod.apply(p, x), params, _J(x))
    with torch.no_grad():
        out = m(x)
    assert len(plain) == 2
    _check(out, ref, dt, 2e-5)



@pytest.mark.slow
def test_vae_resnet_block_full_width_bf16(monkeypatch, interpret_ref):
    """One fused ResBlock at the decoder's 64^2 x 512 -> 512 in bf16 under the
    real gates (MVDF_CONV3X3=1; the reference's asked as on a TPU), against
    the reference's fused branch in interpret mode: a first full-width check."""
    _set_switches(monkeypatch, False, True)
    monkeypatch.setattr(jc3, "should_fuse_conv3x3", _ref_conv_gate)
    shape = (1, 64, 64, 512)
    assert C3.should_fuse_conv3x3(shape) and _ref_conv_gate(shape)
    m, params = _block_pair(512, 512, BF, seed=7)
    x = torch.tensor(np.random.default_rng(7).normal(size=shape).astype(np.float32)).to(BF)
    ref = _jit(lambda p, x: JVAEResnetBlock(512, dtype=jnp.bfloat16).apply(p, x), params, _J(x))
    with torch.no_grad():
        out = m(x)
    _check(out, ref, BF, None)


# ------------------------------------------------------------ whole VAE
def _both_forms(monkeypatch):
    """Both switches on, both sides: the tiled GroupNorm above 2^16 elements
    an image (the tiny VAE's 64^2 x 32 maps, in 8 tiles of 512 rows; its
    32^2 and 16^2 maps stay on K1) and the fused conv on maps of at least
    32^2 (the reference's gate needs C % 128 == 0, which no tiny width has).
    Returns the port's plain-version calls by form."""
    _set_switches(monkeypatch, True, True)
    for mod in (jgn, K):
        monkeypatch.setattr(mod, "_MAX_SLICE_ELEMS", 1 << 16)
        monkeypatch.setattr(mod, "_TILE_ELEMS", 1 << 14)
    monkeypatch.setattr(jgn, "should_fuse_gn", _ref_gn_gate)
    conv_gate = lambda s, groups=32: bool(os.environ.get("MVDF_CONV3X3")) and s[1] * s[2] >= 32 * 32 and (
        s[-1] % groups == 0)
    monkeypatch.setattr(jc3, "should_fuse_conv3x3", conv_gate)
    monkeypatch.setattr(C3, "should_fuse_conv3x3", conv_gate)
    calls = []
    monkeypatch.setattr(C3, "conv3x3_plain", lambda *a: calls.append("conv") or _CONV_PLAIN(*a))
    monkeypatch.setattr(K, "group_norm_tiled_plain", lambda *a: calls.append("tiled") or _TILED_PLAIN(*a))
    return calls


def test_vae_encode_decode_both_forms_match(pair, monkeypatch, interpret_ref):
    """encode_images + decode_latents at the tiny config with both switches
    on, against the JAX model with the same gates (its kernels in interpret
    mode); fp32, 1e-4 x max|ref|. The port's plain versions of both forms
    are counted: the encoder's and decoder's 64^2 and 32^2 ResBlocks fuse,
    the decoder's 64^2 norm_out takes the tiled form."""
    calls = _both_forms(monkeypatch)
    p = pair
    params = nest(p["flat"])
    images = p["scene"]["images"]
    ref_z = _jit(lambda q, a: p["jm"].apply(q, a, method=JViewFusion.encode_images), params, jnp.asarray(images))
    z = np.random.default_rng(9).normal(size=ref_z.shape).astype(np.float32)
    ref_img = _jit(lambda q, a: p["jm"].apply(q, a, method=JViewFusion.decode_latents), params, jnp.asarray(z))
    with torch.no_grad():
        lat = p["model"].encode_images(torch.tensor(images))
        img = p["model"].decode_latents(torch.tensor(z))
    rel_close(lat, ref_z, 1e-4)
    rel_close(img, ref_img, 1e-4)
    # encoder: 2 fused blocks (64^2, 32^2); decoder: 4 (two at each of 32^2 and
    # 64^2), 2 convs each; the tiled form at the decoder's 64^2 x 32 norm_out
    assert sorted(calls) == ["conv"] * 12 + ["tiled"], calls


def test_chip_smoke_vae_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's vae phase at the tiny config on the CPU, with the
    gates lowered as in test_vae_encode_decode_both_forms_match so that both
    forms run: the same control flow and checks as on the card, minus the
    launch counts; the switches are off again afterwards."""
    import importlib.util
    from pathlib import Path

    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusionConfig

    calls = _both_forms(monkeypatch)
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.run_vae("cpu", device="cpu", cfg=ViewFusionConfig().tiny()) == {}
    assert {"conv", "tiled"} <= set(calls)
    assert not any(os.environ.get(v) for v in SWITCHES)


# ---------------------------------------------------------------- K1, bf16
@pytest.mark.parametrize("shape", [(2, 1024, 320), (1, 1024, 512)], ids=["unet_32x32x320", "vae_32x32x512"])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_k1_bf16_matches_pallas(shape, act):
    """K1's plain version in bf16 against _gn_kernel in interpret mode (XLA's
    excess precision off), at a UNet 32^2 site's shape and the VAE's 32^2 x
    512. Measured on the CPU: 0.25-0.5 ulp of max|ref|, mean <= 6.7e-8 x
    max|ref| (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(11)
    C = shape[-1]
    x = torch.tensor((rng.normal(size=shape) * 3 + 1).astype(np.float32)).to(BF)
    g = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    b = (0.1 * rng.normal(size=C)).astype(np.float32)
    ref = _jit(lambda x, g, b: jgn.group_norm_act(x, g, b, 32, 1e-6, act, True), _J(x), jnp.asarray(g), jnp.asarray(b))
    _check(K.group_norm_act(x, torch.tensor(g), torch.tensor(b), 32, 1e-6, act), ref, BF, None)
