"""K4's host side around its Hopper kernels, on the CPU at tiny widths: the
qkv tile's plan over the token rows, the per-head packing of the qkv weights
that the tile reads, the two-phase gather's folded GELU, and the launchers'
wiring with each kernel replaced by its plain version.

The qkv tile (csrc/gemm_sm90.cu::qkv_attention_sm90_kernel) holds whole
points: floor(128 / V) of them, V rows each, point-major. The plain versions
read the unpacked [Wq; Wk; Wv] layout, so prepared (packed) weights give them
the same bits as the parameters as they are. Exact comparisons (torch.equal)
except where a kernel's own arithmetic is replaced (the launcher test).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvdfusion_tpu_torch.ops import crossview as K4

BF = torch.bfloat16


@pytest.mark.parametrize("V", range(1, 17))
def test_qkv_tile_plan_covers_each_row_once_in_whole_points(V):
    """For V = 1..16 and ragged N, the tiles cover every token row exactly
    once, each starts at a point's first row and ends at a point's last, holds
    at most 128 rows, and all but the last hold floor(128 / V) points."""
    P = K4.qkv_tile_points(V)
    assert P == 128 // V and 1 <= P * V <= K4.QKV_TILE_ROWS
    for N in (1, P - 1 or 1, P, P + 1, 3 * P + 2, 1001):
        plan = K4.qkv_tile_plan(N, V)
        covered = np.zeros(N * V, dtype=np.int64)
        for r0, rows in plan:
            assert r0 % V == 0 and rows % V == 0 and 0 < rows <= P * V
            covered[r0 : r0 + rows] += 1
        assert (covered == 1).all()
        assert all(rows == P * V for _, rows in plan[:-1])
        assert len(plan) == -(-N // P)


def _inputs(rng, dt, V=3, Hh=4, hid=64, L=2, heads=2, out_dim=16, nh=7):
    """K4's operands from a numpy seed, as launch_crossview takes them."""
    r = lambda *s, std=1.0, d=torch.float32: torch.tensor((rng.normal(size=s) * std).astype(np.float32)).to(d)
    N, mlp, G = V * Hh * Hh, 2 * hid, 7 * (1 + 2 * nh)
    lin = lambda o, i: r(o, i, std=i**-0.5, d=dt)
    w = K4.AggregatorWeights(
        qkv_w=[lin(3 * hid, hid) for _ in range(L)], qkv_b=[r(3 * hid, std=0.1) for _ in range(L)],
        proj_w=[lin(hid, hid) for _ in range(L)], proj_b=[r(hid, std=0.1) for _ in range(L)],
        fc1_w=[lin(mlp, hid) for _ in range(L)], fc1_b=[r(mlp, std=0.1) for _ in range(L)],
        fc2_w=[lin(hid, mlp) for _ in range(L)], fc2_b=[r(hid, std=0.1) for _ in range(L)],
        mods=r(L, 6, hid, std=0.5), wl_w=lin(1, hid), wl_b=r(1, std=0.1), fin_w=lin(out_dim, hid),
        fin_b=r(out_dim, std=0.1))
    kg = K4.GeoWeights(kall=r(G, hid, std=G**-0.5, d=dt), kmask=r(hid, std=0.1))
    return (r(V, N, 2, std=0.6), r(N, 3), r(V, 3, std=2.0), torch.ones(V), r(N, hid, d=dt), r(V, Hh, Hh, hid, d=dt),
            kg, w, heads, tuple(0.1 * 2.0**i for i in range(nh)))


def test_qkv_head_packing_is_undone_exactly():
    """pack_qkv_heads puts head h's q, k and v rows side by side at rows
    96 h .. 96 (h + 1) (dh = 32); unpack_qkv_heads restores [Wq; Wk; Wv] and
    the bias bit for bit."""
    rng = np.random.default_rng(0)
    heads, dh, K = 4, 32, 40
    w = torch.tensor(rng.normal(size=(3 * heads * dh, K)).astype(np.float32)).to(BF)
    b = torch.tensor(rng.normal(size=3 * heads * dh).astype(np.float32))
    wp, bp = K4.pack_qkv_heads(w, b, heads)
    hid = heads * dh
    for h in range(heads):
        for part in range(3):
            rows = slice(3 * dh * h + dh * part, 3 * dh * h + dh * (part + 1))
            src = slice(part * hid + h * dh, part * hid + (h + 1) * dh)
            assert torch.equal(wp[rows], w[src]) and torch.equal(bp[rows], b[src])
    w2, b2 = K4.unpack_qkv_heads(wp, bp, heads)
    assert torch.equal(w2, w) and torch.equal(b2, b)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("form", ["single", "two_phase"])
def test_plain_versions_on_packed_weights_match_unprepared(dt, form):
    """Both forms' plain versions, and view_attention_plain, fed the prepared
    weights (qkv packed per head, the frequencies on the device) give the
    bits they give on the weights as they are."""
    rng = np.random.default_rng(1)
    args = _inputs(rng, dt)
    heads, freqs = args[8], args[9]
    kg, w = K4.prepare_crossview_weights(args[6], args[7], dt, heads, freqs)
    assert isinstance(w, K4.PreparedAggregator) and w.qkv_heads == heads and kg.freqs is not None
    assert not torch.equal(w.qkv_w[0], args[7].qkv_w[0].to(dt))  # packed, not the same layout
    plain = K4.crossview_plain if form == "single" else K4.crossview_two_phase_plain
    want = plain(*args)
    assert torch.equal(plain(*args[:6], kg, w, *args[8:]), want)
    assert K4.prepare_crossview_weights(kg, w, dt, heads, freqs)[1] is w  # prepared passes unchanged
    N, V = args[0].shape[1], args[0].shape[0]
    h = torch.tensor(rng.normal(size=(N * V, 64)).astype(np.float32)).to(dt)
    raw = args[7]
    ref = (K4._attention_plain(K4._mm(h, raw.qkv_w[0], raw.qkv_b[0], dt), N, V, heads)).to(dt)
    assert torch.equal(K4.view_attention_plain(h, w.qkv_w[0], w.qkv_b[0], V, heads), ref)


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
def test_two_phase_gather_folds_the_gelu_as_the_plain_version(monkeypatch, dt):
    """The two-phase gather's output, written as its plain form
    (gather_stream_plain: each token rounded to the maps' dtype, + b_acc, the
    GELU, in one pass), is the tensor crossview_two_phase_plain hands its DiT
    after its separate tokens -> GELU steps, bit for bit; in fp32 the two
    forms' streams agree."""
    rng = np.random.default_rng(2)
    args = _inputs(rng, dt)
    xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs = args
    fed = []
    dit = K4._dit_pool_plain
    monkeypatch.setattr(K4, "_dit_pool_plain", lambda x, *a: fed.append(x) or dit(x, *a))
    out = K4.crossview_two_phase_plain(*args)
    stream = K4.gather_stream_plain(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, two_phase=True)
    N, V, hid = xy.shape[1], xy.shape[0], maps_p.shape[-1]
    assert stream.shape == (N * V, hid) and stream.dtype == torch.float32
    assert torch.equal(stream, fed[0].reshape(N * V, hid))
    assert torch.equal(dit(stream.reshape(N, V, hid), w, heads, dt), out)
    single = K4.gather_stream_plain(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, two_phase=False)
    assert torch.equal(single, stream) == (dt == torch.float32)


@pytest.mark.parametrize("form", ["single", "two_phase"])
def test_launchers_on_plain_kernels_match_plain(monkeypatch, form):
    """launch_crossview and launch_crossview_two_phase, with every K4 kernel
    replaced by its plain version and the GEMMs taking theirs (CPU tensors),
    on prepared weights: within fp32 rounding of the plain form on the raw
    weights (the GEMM's GELU is written as the kernel's formula, the plain
    form's is F.gelu)."""
    rng = np.random.default_rng(3)
    dt = torch.float32
    args = _inputs(rng, dt)
    calls = []

    def gather(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, mode):
        calls.append(("gather", mode))
        assert kg.freqs is not None and mode == form
        return K4.gather_stream_plain(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, mode == "two_phase")

    def layernorm(x, scale, shift, out_dt):
        calls.append("ln")
        return (K4._layernorm_plain(x) * (1 + scale) + shift).to(out_dt)

    def attention(h, qkv_w, qkv_b, V, heads):
        calls.append("attention")
        return K4.view_attention_plain(h, qkv_w, qkv_b, V, heads)

    def pool(x, N, V, wl_w, wl_b, out_dt):
        calls.append("pool")
        ww = torch.softmax(K4._mm(x, wl_w, wl_b, out_dt).reshape(N, V), dim=-1)
        return (x.reshape(N, V, -1) * ww[..., None]).sum(dim=1).to(out_dt)

    monkeypatch.setattr(K4, "launch_gather", gather)
    monkeypatch.setattr(K4, "dit_layernorm", layernorm)
    monkeypatch.setattr(K4, "view_attention", attention)
    monkeypatch.setattr(K4, "launch_pool", pool)
    launch = K4.launch_crossview if form == "single" else K4.launch_crossview_two_phase
    plain = K4.crossview_plain if form == "single" else K4.crossview_two_phase_plain
    kw = K4.prepare_crossview_weights(args[6], args[7], dt, args[8], args[9])
    got, want = launch(*args[:6], *kw, *args[8:]), plain(*args)
    L = len(args[7].qkv_w)
    assert calls == [("gather", form)] + ["ln", "attention", "ln"] * L + ["pool"]
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_routes_by_dtype_and_shape():
    """The gather takes the tensor-core form for bf16 maps with hid a
    multiple of 64 up to 512 and G <= 112; the view attention runs in the
    qkv tile for bf16 at dh = 32, hid <= 256 and V <= 16; every other case
    takes the CUDA-core gather and the standalone attention kernel."""
    assert K4.gather_route(BF, 256, 7) == "mma" and K4.gather_route(BF, 512, 7) == "mma"
    assert K4.gather_route(torch.float32, 256, 7) == "simt"
    assert K4.gather_route(BF, 32, 7) == "simt" and K4.gather_route(BF, 256, 8) == "simt"
    for V in (1, 3, 8, 15, 16):
        assert K4.attention_route(BF, V, 256, 8) == "fused"
    assert K4.attention_route(torch.float32, 8, 256, 8) == "standalone"
    assert K4.attention_route(BF, 8, 256, 4) == "standalone"  # dh = 64
    assert K4.attention_route(BF, 8, 512, 16) == "standalone"  # K = 512 does not fit the tile
    assert K4.attention_route(BF, 17, 256, 8) == "standalone"
