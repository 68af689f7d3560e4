"""K5's and K6's host side around their Hopper kernels, on the CPU at small
widths: the plan of K5's six wgmma products against the six GEMM calls of
the split form (K3), their operands against TMA's rules, and K6's attention
plan and tile order.

K5 (csrc/blockforms.cu::site_kernel) runs its bf16 products on the wgmma
GEMM's epilogue (pass2_kind) in the phases that `site_gemm_phases` lists,
reading its workspace and the prepared weights through tensor maps
(SITE_MAPS). K6's tensor-core attention (bigattn_sm90_kernel) gives each
block one head and 64 x consumers token rows of whole batch elements, one
consumer warpgroup a 64-row slice; `big_attention_tiles_plain` walks that
plan on the CPU with the tile's rounding points and must give the bits of
qkv_attention_plain. Exact comparisons (torch.equal) throughout.
"""

import numpy as np
import pytest
import torch

from mvdfusion_tpu_torch.ops import block as K3
from mvdfusion_tpu_torch.ops.attention import attention_plain

BF = torch.bfloat16


def _site(seed, B, N, C, dt):
    rng = np.random.default_rng(seed)
    inner = 4 * C
    r = lambda *s, std=1.0: torch.tensor((rng.normal(size=s) * std).astype(np.float32))
    mats = dict(pi_w=(C, C), qkv_w=(3 * C, C), out_w=(C, C), g_w=(2 * inner, C), f_w=(C, inner), po_w=(C, C))
    w = {}
    for f in K3.BlockWeights._fields:
        if f in mats:
            w[f] = r(*mats[f], std=mats[f][1] ** -0.5).to(dt)
        else:
            w[f] = (1.0 if f in ("gn_w", "ln1_w", "ln3_w") else 0.0) + r(2 * inner if f == "g_b" else C, std=0.1)
    return r(B, N, C).to(dt), r(B, C).to(dt), K3.BlockWeights(**w)


def _epilogue_kind(kw, out_bf16: bool) -> str:
    """csrc/gemm.cuh::epilogue_kind for a `gemm` call's keywords."""
    r = bool(kw.get("steps")) and out_bf16
    act, gate = kw.get("act", K3.ACT_NONE), kw.get("gate")
    res1, res2 = kw.get("res1") is not None, kw.get("res2") is not None
    if act == K3.ACT_GEGLU:
        return "geglu" if gate is None and not res1 and not res2 and r else "generic"
    if gate is not None or act == K3.ACT_GELU:
        return "other"
    if res2:
        return "res2" if res1 else "generic"
    return "res1" if res1 else "bias"


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,N,C,heads", [(2, 64, 64, 4), (3, 96, 128, 2)])
def test_site_gemm_phases_are_k3s_products(monkeypatch, dt, B, N, C, heads):
    """The split form's six `gemm` calls, recorded on the CPU (K1, the
    LayerNorm and K2 replaced by their plain versions), have the (M, N, K),
    weights, bias, operands and (bf16) epilogue kind of site_gemm_phases, each
    operand named by the K5 buffer that holds it: a product's output by the
    phase that wrote it, x's rows as "x", attn2 as "a2", and every other
    stage's output (GroupNorm, LayerNorm, attention) as "A"."""
    x, a2, w = _site(0, B, N, C, dt)
    wp = K3.prepare_site_weights(w, dt)
    fields = {id(getattr(wp, f)): f for f in K3.PreparedSite._fields}
    plan = K3.site_gemm_phases(B, N, C, w.f_w.shape[1])
    calls, made, keep = [], {x.data_ptr(): "x"}, []
    monkeypatch.setattr(K3, "layernorm", lambda h, g, b: K3._ln_plain(h, g, b))
    monkeypatch.setattr(K3, "launch_group_norm", lambda t, g, b, G, eps: K3.group_norm_plain(t, g, b, G, eps))
    monkeypatch.setattr(K3, "launch_attention", lambda *a: attention_plain(*a).contiguous())

    def record(a, wt, bias=None, **kw):
        out = K3.gemm_plain(a, wt, bias, **kw)
        name = lambda t: None if t is None else made.get(t.data_ptr(), "A")
        calls.append(dict(a=name(a), w=fields[id(wt)], M=a.shape[0], N=wt.shape[0], K=a.shape[1],
                          bias=None if bias is None else fields[id(bias)], res1=name(kw.get("res1")),
                          res2=None if kw.get("res2") is None else "a2", kind=_epilogue_kind(kw, dt == BF)))
        made[out.data_ptr()] = plan[len(calls) - 1].out
        keep.append(out)  # alive, so that no later tensor takes its address
        return out

    monkeypatch.setattr(K3, "gemm", record)
    got = K3.launch_transformer_block(x, a2, wp, heads)
    assert len(calls) == len(plan) == 6
    for call, ph in zip(calls, plan):
        want = {k: getattr(ph, k) for k in call}
        if dt != BF:  # the epilogue kinds are the bf16 wgmma path's; fp32 keeps the CUDA-core tile
            call.pop("kind"), want.pop("kind")
        assert call == want, ph.name
    assert torch.equal(got, K3.transformer_block_plain(x, a2, w, heads))


@pytest.mark.parametrize("B,N,C,inner", [(16, 1024, 320, 1280), (30, 1024, 320, 1280), (3, 96, 64, 256)])
def test_site_gemm_operands_meet_tma_rules(B, N, C, inner):
    """Every A and W operand of K5's products is a row-major bf16 matrix that
    TMA can read in the kernel's boxes: a 16-byte row stride, K a whole
    number of 64-column boxes (the 128-byte swizzle's row), box heights of
    at most 256 rows (64 for A, 128 for W, whose maps are the site GEMM's);
    the operands' buffers in SITE_MAPS' order, the workspace's bases
    16-byte aligned, and `big` large enough for both of its shapes."""
    plan = K3.site_gemm_phases(B, N, C, inner)
    assert K3.SITE_A_BOX == 64 and K3.SITE_W_BOX == K3.GEMM_TILE_N == 128
    for ph in plan:
        assert ph.a in K3.SITE_MAPS[:3] and ph.w in K3.SITE_MAPS[3:]
        assert (ph.K * 2) % 16 == 0 and ph.K % 64 == 0
        assert 8 <= K3.SITE_A_BOX <= 256 and 8 <= K3.SITE_W_BOX <= 256
        assert ph.M == B * N
    assert [ph.w for ph in plan] == list(K3.SITE_MAPS[3:])
    if B * N <= 4096:
        ws = K3._site_workspace(B, N, C, inner, BF, "cpu")
        assert all(t.data_ptr() % 16 == 0 for t in ws)
        stats, A, H, big, stamps = ws
        assert A.shape == H.shape == (B * N, C) and big.numel() >= B * N * max(3 * C, inner)
        assert stats.numel() == B * -(-N // K3.SITE_GN_ROWS) * 32 * 2
        assert stamps.numel() == len(K3.SITE_PHASES) + 2


@pytest.mark.parametrize("N", [64, 128, 192, 256])
@pytest.mark.parametrize("B", [1, 2, 3, 16, 30])
def test_big_attention_plan_covers_each_row_once(B, N):
    """For the big-C sites' shapes (C = 1280, 8 heads, dh = 160) the route is
    the tensor-core tile at N = 64 and 128 and the CUDA-core kernel at 192
    and 256. The tile's plan (both warpgroup counts at N = 64) covers every
    (batch, token row) of a head exactly once, in 64-row slices that each
    lie in one batch element, at most 128 rows a block, the blocks holding
    whole batch elements; the CUDA-core plan holds one batch element a
    block, in 64-query slabs."""
    route = K3.big_attention_route(BF, N, 1280, 8)
    assert route == ("sm90" if N <= 128 else "cores")
    for cons in ((1, 2) if N == 64 else (2,)) if route == "sm90" else (None,):
        plan = K3.big_attention_plan(B, N, cons, route)
        covered = np.zeros((B, N), dtype=np.int64)
        for block in plan:
            rows = sum(n for _, _, n in block)
            if route == "sm90":
                assert rows <= 128 and len(block) <= cons
            batches = {b for b, _, _ in block}
            for b in batches:  # whole batch elements
                assert sum(n for bb, _, n in block if bb == b) == N
            for b, n0, n in block:
                assert n == 64 and n0 % 64 == 0 and n0 + n <= N
                covered[b, n0 : n0 + n] += 1
        assert (covered == 1).all()
        if route == "sm90":
            assert len(plan) == -(-B * N // (64 * cons))


@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,N,cons", [(3, 64, 2), (3, 64, 1), (2, 128, 2), (1, 192, None), (1, 256, None)])
def test_big_attention_tile_order_equals_plain(dt, B, N, cons):
    """The kernel's tile order on the CPU (each block's q, k and v rounded
    per head as the tile rounds them, each slice attended against its batch
    element's keys) gives qkv_attention_plain's bits, in fp32 and bf16;
    N = 192 and 256 walk the CUDA-core kernel's plan."""
    rng = np.random.default_rng(3)
    C, heads = 320, 2  # dh = 160, the tile's head width
    ln1 = torch.tensor(rng.normal(size=(B, N, C)).astype(np.float32)).to(dt)
    qkv_w = torch.tensor((rng.normal(size=(3 * C, C)) * C**-0.5).astype(np.float32)).to(dt)
    route = "sm90" if N <= 128 else "cores"
    got = K3.big_attention_tiles_plain(ln1, qkv_w, heads, cons, route)
    assert torch.equal(got, K3.qkv_attention_plain(ln1, qkv_w, heads))


def test_big_attention_route_by_shape():
    """The tensor-core tile takes bf16 at dh = 160 and N = 64 or 128 only;
    fp32 operands and other head widths keep the CUDA-core kernel."""
    assert K3.big_attention_route(BF, 64, 1280, 8) == "sm90"
    assert K3.big_attention_route(BF, 128, 1280, 8) == "sm90"
    assert K3.big_attention_route(torch.float32, 64, 1280, 8) == "cores"
    assert K3.big_attention_route(BF, 64, 1280, 10) == "cores"
    assert K3.big_attention_route(BF, 64, 256, 2) == "cores"
    with pytest.raises(ValueError):
        K3.big_attention_plan(2, 192, 2)


def test_big_attention_consumers_fill_one_wave():
    """At N = 64 the tile takes one warpgroup a block while heads x B blocks
    fit the card's SMs in one wave (the flagship's CFG batch 16: 128 blocks
    on 132 SMs), two past that (the eval path's 30: 120 blocks of two batch
    elements); N = 128 always takes two."""
    assert K3.big_attention_consumers(16, 64, 8, 132) == 1
    assert K3.big_attention_consumers(30, 64, 8, 132) == 2
    assert K3.big_attention_consumers(1, 128, 8, 132) == 2
    for B in (1, 2, 3, 16, 30):
        cons = K3.big_attention_consumers(B, 64, 8, 132)
        assert 8 * len(K3.big_attention_plan(B, 64, cons)) <= 132 or cons == 2
