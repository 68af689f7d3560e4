"""K7's host side on the CPU: the GroupNorm route (ops/groupnorm.py::gn_route)
at every VAE shape against the reference's, the stats pass's tile plan
(plan_gn_tiled), and a CPU emulation of the stats pass's summation order
(csrc/groupnorm.cu::gn_stats_kernel) against the plain fold and the JAX
package's gn_fold_affine and _gn_tiled_impl in interpret mode.

No card is needed: the route and the plan are host arithmetic, and the
emulation repeats the kernel's sums in its order in fp32 (the card contracts
x*x + s into one fma, which the emulation rounds twice: agreement to 1e-6,
not bit for bit). Tolerances: the emulated fold against
fold_affine(channel_sums_plain(x)) 1e-6 x max|plain| (fp32 sums in another
order); against JAX 1e-5 max-abs for the fold's (a, b) and for fp32
GroupNorm outputs, and the file's bf16 check for bf16 outputs (1 bf16 ulp of
max|ref|, mean 1e-4 x max|ref|: the fp32 results round to bf16 on both
sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.ops.conv3x3 as jc3
import mvdfusion_tpu.ops.groupnorm as jgn
from mvdfusion_tpu_torch.nn.layers import GroupNorm32
from mvdfusion_tpu_torch.ops import groupnorm as K
from test_torch_port_vae import _J, _check, _jit, _ref_gn_gate, _set_switches, _vae_shapes

BF = torch.bfloat16


# ------------------------------------------------------------------- route
def _reference_route(shape, gated=True):
    """The route before the card's repair, as the reference dispatches: its
    gate (asked as on a TPU) in front of the model's GroupNorms, then
    _gn_fwd_impl: K1 up to 2^20 elements an image, the tiled form where
    _pick_tile finds a tile, else XLA's GroupNorm (the plain version)."""
    n, C = shape[1] * shape[2], shape[3]
    if gated and not _ref_gn_gate(shape, 32):
        return "plain"
    if n * C <= 1 << 20:
        return "k1"
    return "k7" if jgn._pick_tile(n, C) is not None else "plain"


@pytest.mark.parametrize("gn_tiled", [False, True], ids=["gn_off", "gn_tiled"])
def test_route_is_the_reference_on_the_cpu_and_k7_on_the_card(monkeypatch, gn_tiled):
    """At every VAE shape, with MVDF_GN_TILED set and unset: on "cpu" the
    route equals the reference's, gated (GroupNorm32) and ungated
    (group_norm_act); on "cuda" every map above 2^20 elements an image
    whose C K7 takes goes to K7, every other such map to the plain version,
    and every smaller map keeps the CPU's route."""
    _set_switches(monkeypatch, gn_tiled, False)
    large = 0
    for shape in _vae_shapes():
        n, C = shape[1] * shape[2], shape[3]
        for gated in (True, False):
            cpu = K.gn_route(shape, 32, "cpu", gated)
            assert cpu == _reference_route(shape, gated), (shape, gated)
            cuda = K.gn_route(shape, 32, "cuda", gated)
            if n * C > 1 << 20 and C % 32 == 0 and C % 8 == 0 and C <= 1024:
                assert cuda == "k7", (shape, gated)
                large += 1
            elif n * C > 1 << 20:
                assert cuda == "plain", (shape, gated)
            else:
                assert cuda == cpu, (shape, gated)
    # the VAE's large maps: 128^2, 256^2 and 64^2 x 512 at B = 9, 8, 7, and
    # the refused shapes' (8, 64, 64, 320) and (2, 4096, 8, 128)
    assert large == 2 * (3 * 7 + 2)


def test_route_leaves_plain_only_what_k7_cannot_take(monkeypatch):
    """On the card a large map stays plain only where C is not a multiple of
    the groups or of 8, or above GNT_MAX_C, gated or not and with
    MVDF_GN_TILED set or unset (the reference's _pick_tile finds a tile at
    (1, 64, 64, 2048), which K7 cannot take); small maps keep K1's gate."""
    for gn_tiled in (False, True):
        _set_switches(monkeypatch, gn_tiled, False)
        for gated in (True, False):
            assert K.gn_route((8, 256, 256, 130), 32, "cuda", gated) == "plain"  # C % 32
            assert K.gn_route((8, 256, 256, 130), 10, "cuda", gated) == "plain"  # C % 8
            assert K.gn_route((1, 1024, 1024, 8), 8, "cuda", gated) == "k7"
            assert K.gn_route((1, 64, 64, 2048), 32, "cuda", gated) == "plain"  # above GNT_MAX_C
            assert K.gn_route((1, 64, 64, 1024), 32, "cuda", gated) == "k7"
            assert K.gn_route((1, 100, 100, 64), 32, "cuda", gated) == "k1"
        assert K.gn_route((1, 100, 100, 65), 32, "cuda") == "plain"
    assert jgn._pick_tile(64 * 64, 2048) is not None


def test_groupnorm32_follows_the_route(monkeypatch):
    """GroupNorm32 hands group_norm_act the route it was given by gn_route
    for its input's device: on the CPU without MVDF_GN_TILED a large map
    takes the plain version, and with the route patched to the card's it
    takes K7's plain version (the path a CUDA tensor launches K7 on)."""
    _set_switches(monkeypatch, False, False)
    for mod in (jgn, K):
        monkeypatch.setattr(mod, "_MAX_SLICE_ELEMS", 1 << 12)
        monkeypatch.setattr(mod, "_TILE_ELEMS", 1 << 11)
    calls = []
    real_tiled, real_plain = K.group_norm_tiled_plain, K.group_norm_plain
    monkeypatch.setattr(K, "group_norm_tiled_plain", lambda *a: calls.append("k7") or real_tiled(*a))
    monkeypatch.setattr(K, "group_norm_plain", lambda *a: calls.append("plain") or real_plain(*a))
    gn = GroupNorm32(64, eps=1e-6, act="silu")
    x = torch.randn(2, 16, 16, 64, generator=torch.Generator().manual_seed(0))
    plain = gn(x)
    real_route = K.gn_route
    import mvdfusion_tpu_torch.nn.layers as layers

    monkeypatch.setattr(layers, "gn_route", lambda shape, groups, dev, gated=True: real_route(shape, groups, "cuda"))
    tiled = gn(x)
    assert calls == ["plain", "k7"]
    assert (tiled - plain).abs().max() <= 1e-5


# -------------------------------------------------------------------- plan
VAE_TILED = [(B, N, C) for B in (7, 8, 9) for N, C in ((65536, 128), (65536, 256), (16384, 256), (16384, 512),
                                                       (4096, 512), (65536, 512))]
RAGGED = [(2, 3000, 96), (3, 700, 40), (1, 100003, 64), (30, 1000, 1024), (1, 8, 8)]


@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sms", [132, 114, 4])
def test_tiled_plan_covers_rows_and_fits_the_card(dtype, sms):
    """Every tile holds at least one row, the tiles cover each row of a
    sample exactly once, and a tile is whole steps of the CTA's P row lanes
    x GNT_UNROLL; the CTA's channel vectors and lanes fit its threads, and
    the grid fills at most one wave of GNT_BLOCKS_PER_SM CTAs an SM (where
    one tile a sample fits in it)."""
    vec = 8 if dtype == BF else 4
    for B, N, C in VAE_TILED + RAGGED:
        plan = K.plan_gn_tiled(B, N, C, dtype, sms)
        cv = C // vec
        assert plan.P == K.GNT_THREADS // cv and 1 <= plan.P and cv * plan.P <= K.GNT_THREADS, (B, N, C, plan)
        assert plan.rows % (plan.P * K.GNT_UNROLL) == 0, (B, N, C, plan)
        assert (plan.tiles - 1) * plan.rows < N <= plan.tiles * plan.rows, (B, N, C, plan)
        covered = np.zeros(N, np.int64)
        for t in range(plan.tiles):
            for lane in range(plan.P):  # the rows a lane walks, in either direction
                covered[t * plan.rows + lane:min(N, (t + 1) * plan.rows):plan.P] += 1
        assert (covered == 1).all(), (B, N, C, plan)
        if B <= sms * K.GNT_BLOCKS_PER_SM:
            assert B * plan.tiles <= sms * K.GNT_BLOCKS_PER_SM, (B, N, C, plan)


def test_tiled_plan_fills_one_wave_at_the_vae_shapes():
    """At the VAE's shapes on the H100's 132 SMs the grid takes at least 80%
    of one wave's 528 CTA slots, and every thread of a CTA has a vector."""
    for B, N, C in VAE_TILED:
        plan = K.plan_gn_tiled(B, N, C, BF)
        assert 0.8 * 528 <= B * plan.tiles <= 528, (B, N, C, plan)
        assert (C // 8) * plan.P == K.GNT_THREADS


def test_tiled_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        K.plan_gn_tiled(2, 4096, 100, BF)  # not whole 16-byte vectors
    with pytest.raises(ValueError):
        K.plan_gn_tiled(2, 4096, 4 * K.GNT_THREADS + 4, torch.float32)  # more vectors than threads
    with pytest.raises(TypeError):
        K.plan_gn_tiled(2, 4096, 128, torch.float16)


# --------------------------------------------------------------- emulation
def emulate_stats(x, weight, bias, groups: int, eps: float, clamp: bool, plan):
    """gn_stats_kernel's sums in its order, fp32: the thread of row lane l
    and channel vector v adds rows l, l + P, ... of its tile in order from
    0; the CTA adds its P lanes in order into the tile's partials; the
    folding CTA adds the partials in tile order from 0, then each group's
    channels in order from 0; mu = s1 / cnt, var = s2 / cnt - mu^2 (clamped
    at 0 where `clamp`), a = rsqrt(var + eps) * weight, b = bias - mu * a."""
    B, N, C = x.shape
    xf, P = x.float(), plan.P
    part = torch.zeros(plan.tiles, 2, B, C)
    for t in range(plan.tiles):
        tile = xf[:, t * plan.rows:min(N, (t + 1) * plan.rows)]
        lanes = torch.zeros(2, B, P, C)
        for k in range(0, tile.shape[1], P):
            rows = tile[:, k:k + P]
            lanes[0, :, :rows.shape[1]] += rows
            lanes[1, :, :rows.shape[1]] += rows * rows
        acc = lanes[:, :, 0]
        for lane in range(1, P):
            acc = acc + lanes[:, :, lane]
        part[t] = acc
    sums = torch.zeros(2, B, C)
    for t in range(plan.tiles):
        sums = sums + part[t]
    cg = C // groups
    g = torch.zeros(2, B, groups)
    for k in range(cg):
        g = g + sums.reshape(2, B, groups, cg)[..., k]
    cnt = float(N) * float(cg)
    mu = g[0] / cnt
    var = g[1] / cnt - mu * mu
    if clamp:
        var = var.clamp_min(0.0)
    a = torch.rsqrt(var + eps).repeat_interleave(cg, dim=-1) * weight.float()
    return a, bias.float() - mu.repeat_interleave(cg, dim=-1) * a


def _inputs(seed, B, N, C, dt):
    rng = np.random.default_rng(seed)
    x = torch.tensor((rng.normal(size=(B, N, C)) * 3 + 1).astype(np.float32)).to(dt)
    w = torch.tensor((1 + 0.1 * rng.normal(size=C)).astype(np.float32))
    b = torch.tensor((0.1 * rng.normal(size=C)).astype(np.float32))
    return x, w, b


def _rel(got, want, tol):
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    assert err <= tol * top, f"max|diff| {err:.3e} > {tol:g} x {top:.3e}"


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,sms", [((2, 3000, 96), 132), ((2, 3000, 96), 4), ((3, 700, 40), 132),
                                       ((2, 2048, 512), 16)],
                         ids=["ragged", "few_tiles", "c40", "c512"])
@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "unclamped"])
def test_emulated_stats_match_the_plain_fold(dt, shape, sms, clamp):
    """The emulated stats pass, on the plan the card would take (a ragged
    last tile at N = 3000 and 700), against fold_affine(channel_sums_plain(x)):
    within 1e-6 x max|plain| for a and for b."""
    B, N, C = shape
    groups = 8 if C == 40 else 32
    x, w, b = _inputs(3, B, N, C, dt)
    plan = K.plan_gn_tiled(B, N, C, dt, sms)
    assert plan.tiles > 1
    a, sh = emulate_stats(x, w, b, groups, 1e-6, clamp, plan)
    s1, s2 = K.channel_sums_plain(x)
    pa, pb = K.fold_affine(s1, s2, w, b, groups, N, 1e-6, clamp)
    _rel(a, pa, 1e-6)
    _rel(sh, pb, 1e-6)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_emulated_stats_match_jax(dt, act):
    """The emulated stats pass (ragged last tiles: 84 rows a tile over 2968
    in bf16, 40 in fp32) against the reference in interpret mode: its unclamped
    fold (conv3x3.gn_fold_affine) within 1e-5 for a and b, and x*a + b
    (+SiLU) from the clamped fold against _gn_tiled_impl: fp32 within 1e-5,
    bf16 by the file's bf16 check."""
    B, N, C = 2, 2968, 96
    x, w, b = _inputs(4, B, N, C, dt)
    plan = K.plan_gn_tiled(B, N, C, dt)
    assert N % plan.rows
    ref_a, ref_b = _jit(lambda x, s, bb: jc3.gn_fold_affine(x, s, bb, 32, 1e-6, True), _J(x), jnp.asarray(w.numpy()),
                        jnp.asarray(b.numpy()))
    a, sh = emulate_stats(x, w, b, 32, 1e-6, False, plan)
    _check(a, ref_a, torch.float32, 1e-5)
    _check(sh, ref_b, torch.float32, 1e-5)
    tile = jgn._pick_tile(N, C)
    ref = _jit(lambda x, s, bb: jgn._gn_tiled_impl(x, s, bb, 32, 1e-6, act, tile, True), _J(x),
               jnp.asarray(w.numpy()), jnp.asarray(b.numpy()))
    a, sh = emulate_stats(x, w, b, 32, 1e-6, True, plan)
    _check(K.apply_affine_plain(x, a, sh, act), ref, dt, 1e-5)
