"""The transformer site's three forms against the JAX package: the split form
(K3), the one-kernel form (K5) and the big-C form (K6); the route that picks
among them; and one apply_model_cfg with both switched forms on.

On the CPU the port's wrappers run their plain versions; the JAX side runs
ops/block.py's Pallas kernels in interpret mode, with its module globals
(_SINGLE_KERNEL_WEIGHT_BYTES, _BIG_C_MIN) monkeypatched as
tests/test_ops_block.py does, and the port's switches set to match. Same
numpy inputs and weights on both sides. Tolerances, stated per test: 1e-4
max-abs in fp32 (sums in another order); in bf16 1 bf16 ulp of max|ref| and a
mean of 1e-4 x max|ref| (both sides round at the same points, so only a
rounding split by an fp32 difference remains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.ops.block as jb
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu_torch.ops import block as K3
from test_torch_port_model import _run_both, pair, rel_close  # noqa: F401 (pair is a fixture)

TOL = 1e-4
BF = torch.bfloat16


def _site(seed, B, N, C, dt, a2_map):
    """Random site weights (matrices in dt, vectors fp32), x and the attn2
    row or map, from a numpy seed."""
    rng = np.random.default_rng(seed)
    inner = 4 * C
    r = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)
    mats = dict(pi_w=(C, C), qkv_w=(3 * C, C), out_w=(C, C), g_w=(2 * inner, C), f_w=(C, inner), po_w=(C, C))
    w = {}
    for f in K3.BlockWeights._fields:
        if f in mats:
            w[f] = torch.tensor(r(*mats[f], std=mats[f][1] ** -0.5)).to(dt)
        else:
            base = 1.0 if f in ("gn_w", "ln1_w", "ln3_w") else 0.0
            w[f] = torch.tensor(base + r(2 * inner if f == "g_b" else C, std=0.1))
    x = torch.tensor(r(B, N, C)).to(dt)
    a2 = torch.tensor(r(B, N, C) if a2_map else r(B, C)).to(dt)
    return x, a2, K3.BlockWeights(**w)


def _J(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == BF else jnp.float32)


def _jax_site(x, a2, w, heads):
    """The JAX op in interpret mode on the same operands (its BlockWeights
    fields are the port's, in the same (out, in) layout and order), compiled
    with XLA's excess precision off: otherwise XLA on the CPU drops the bf16
    roundings between the operations of one kernel body (the one-kernel
    form's h2 never leaves the kernel and measured 5e-4 x max|out| from the
    split form; with the roundings kept the two forms agree bit for bit, as
    they do on the TPU, where every bf16 value is stored as bf16)."""
    jw = jb.BlockWeights(*[_J(t) for t in w])
    args = (_J(x), _J(a2), jw)
    f = jax.jit(lambda x, a2, jw: jb.transformer_block(x, a2, jw, heads, True))
    out = f.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)
    return np.asarray(out.astype(jnp.float32))


def bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def _check(out, ref, dt):
    out = out.float().numpy()
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = np.abs(out - ref)
    if dt == torch.float32:
        assert err.max() <= TOL, f"max|diff| {err.max():.3e} > {TOL:g}"
        return err
    scale = np.abs(ref).max()
    assert err.max() <= bf16_ulp(scale), f"max|diff| {err.max():.3e} vs bf16 ulp {bf16_ulp(scale):.3e}"
    assert err.mean() <= 1e-4 * scale, f"mean|diff| {err.mean():.3e} vs max|ref| {scale:.3e}"
    return err


@pytest.fixture
def single_on(monkeypatch):
    """The one-kernel form on both sides for every small-C site."""
    monkeypatch.setattr(jb, "_SINGLE_KERNEL_WEIGHT_BYTES", 1 << 40)
    monkeypatch.setattr(K3, "_SINGLE_KERNEL_WEIGHT_BYTES", 1 << 40)
    monkeypatch.setenv("MVDF_BLOCK_SINGLE", "1")


@pytest.fixture
def big_on(monkeypatch):
    """The big-C form on both sides from C=32 up (CPU-friendly widths)."""
    monkeypatch.setattr(jb, "_BIG_C_MIN", 16)
    monkeypatch.setattr(K3, "_BIG_C_MIN", 16)
    monkeypatch.setenv("MVDF_BLOCK_BIGC", "1")


# ------------------------------------------------------------- K3, split
@pytest.mark.parametrize("N,C,a2_map", [(256, 32, False), (128, 64, True)])
def test_k3_split_bf16_matches_pallas(N, C, a2_map):
    """The split form's plain version in bf16 against _attn_kernel +
    _ff_kernel in interpret mode, at a SpatialTransformer site (attn2 row)
    and a ViewAligned one (attn2 map). Measured on the CPU: 1 ulp, mean
    1.0e-5 and 1.6e-5 x max|ref|; before the plain version rounded at the
    TPU kernels' points (it rounded each product's epilogue once and its
    logits in bf16), 2 and 1 ulps, mean 5.5e-4."""
    x, a2, w = _site(0, 2, N, C, BF, a2_map)
    assert K3.block_route(2, N, C, 4, 4 * C) == "split"
    _check(K3.transformer_block(x, a2, w, 4, "split"), _jax_site(x, a2, w, 4), BF)


# ------------------------------------------------------------- K5, single
@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("a2_map", [False, True], ids=["row", "map"])
def test_k5_single_matches_pallas(single_on, dt, a2_map):
    """The one-kernel form (_block_kernel in interpret mode) against the
    port's route to it and its plain version, which is the split form's: the
    JAX single and split forms (the budget unbounded and 0) agree bit for bit
    in bf16 and within TOL in fp32 (sums in another order). Measured on the
    CPU: fp32 max|diff| 1.9e-6; bf16 1 and 0.5 ulp, mean 1.5e-5 x max|ref|."""
    B, N, C, heads = 2, 128, 32, 4
    assert K3.block_route(B, N, C, heads, 4 * C) == "single"
    x, a2, w = _site(1, B, N, C, dt, a2_map)
    ref = _jax_site(x, a2, w, heads)
    _check(K3.transformer_block(x, a2, w, heads, "single"), ref, dt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jb, "_SINGLE_KERNEL_WEIGHT_BYTES", 0)
        assert np.abs(_jax_site(x, a2, w, heads) - ref).max() <= (0.0 if dt == BF else TOL)


# ------------------------------------------------------------- K6, big-C
@pytest.mark.parametrize("dt", [torch.float32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N,a2_map", [(64, False), (64, True), (128, False)])
def test_k6_big_matches_pallas(big_on, dt, N, a2_map):
    """The big-C form (_pi_kernel, _bigattn_stream_kernel with its packed
    batches and block-diagonal mask, _h2_kernel, _ff_stream_kernel, in
    interpret mode) against the port's route to it and its plain version.
    Measured on the CPU: fp32 max|diff| <= 1.7e-6; bf16 0.5-1 ulp, mean
    6.9e-6 to 8.7e-6 x max|ref|. The split form's rounding of h2 + FF (twice,
    not once) measured 3.0e-4 to 3.5e-4 and misses the mean bound, so the
    test sees the rounding point."""
    B, C, heads = 2, 32, 4
    assert K3.block_route(B, N, C, heads, 4 * C) == "big"
    x, a2, w = _site(2, B, N, C, dt, a2_map)
    ref = _jax_site(x, a2, w, heads)
    _check(K3.transformer_block(x, a2, w, heads, "big"), ref, dt)
    if dt == BF:
        other = np.abs(K3.transformer_block_plain(x, a2, w, heads).float().numpy() - ref)
        assert other.mean() > 1e-4 * np.abs(ref).max()


# ------------------------------------------------------------------ route
def _reference_route(B, N, C, heads, inner):
    """The form the reference's _fwd_impl computes on its hardware: its gate,
    then _pick_big_nb's fallback, then the weight-bytes test of :535."""
    if not jb.should_fuse_block(C, N, heads):
        return None
    if C > jb._BIG_C_MIN:
        return "big" if jb._pick_big_nb(B, N, False) is not None else None
    inner2 = 2 * inner
    w_bytes = 2 * (6 * C * C + inner2 * C + C * inner2 // 2)
    return "single" if w_bytes <= jb._SINGLE_KERNEL_WEIGHT_BYTES else "split"


@pytest.mark.parametrize("single", [False, True], ids=["split", "single"])
@pytest.mark.parametrize("bigc", [False, True], ids=["bigc_off", "bigc_on"])
def test_block_route_matches_reference(monkeypatch, single, bigc):
    """block_route equals the reference's choice over a grid of (B, N, C),
    8 heads, with either switch on or off (the reference's budget is what
    MVDF_BLOCK_SINGLE=1 sets at its import); the reference's gate is asked
    as on its own hardware."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("MVDF_DISABLE_PALLAS", raising=False)
    for var, on in (("MVDF_BLOCK_SINGLE", single), ("MVDF_BLOCK_BIGC", bigc)):
        if on:
            monkeypatch.setenv(var, "1")
        else:
            monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(jb, "_SINGLE_KERNEL_WEIGHT_BYTES", 8 * 1024 * 1024 if single else 0)
    assert K3._SINGLE_KERNEL_WEIGHT_BYTES == 8 * 1024 * 1024 and K3._BIG_C_MIN == jb._BIG_C_MIN
    seen = set()
    for B in (1, 2, 3, 16, 30):
        for N, C in ((1024, 320), (256, 640), (1024, 640), (4096, 320), (64, 1280), (16, 1280), (128, 1280),
                     (256, 1280), (512, 1280), (96, 1280), (64, 2560), (1024, 384), (256, 768)):
            want = _reference_route(B, N, C, 8, 4 * C)
            assert K3.block_route(B, N, C, 8, 4 * C) == want, (B, N, C)
            seen.add(want)
    # the flagship's sites at CFG batch 16 and the fallback at B=1
    flagship = {(16, 1024, 320): "single" if single else "split", (16, 256, 640): "split",
                (16, 64, 1280): "big" if bigc else None, (16, 16, 1280): None, (1, 64, 1280): None}
    for (B, N, C), form in flagship.items():
        assert K3.block_route(B, N, C, 8, 4 * C) == form, (B, N, C)
    assert seen == {None, "split"} | ({"single"} if single else set()) | ({"big"} if bigc else set())


# ---------------------------------------------------------- whole model
def test_apply_model_cfg_both_forms_matches(pair, monkeypatch):
    """One apply_model_cfg at the tiny config with both switched forms on:
    the one-kernel form at the 16^2 C=32 sites (budget unbounded on both
    sides) and the big-C form at the 8^2 C=64 sites (_BIG_C_MIN 48 on both
    sides), against the JAX model whose interpret mode forces every site
    through ops/block.py. fp32, 1e-3 x max|ref| as the other whole-model
    tests; the port's calls of each form's plain version are counted."""
    monkeypatch.setattr(jb, "_SINGLE_KERNEL_WEIGHT_BYTES", 1 << 40)
    monkeypatch.setattr(jb, "_BIG_C_MIN", 48)
    monkeypatch.setattr(K3, "_SINGLE_KERNEL_WEIGHT_BYTES", 1 << 40)
    monkeypatch.setattr(K3, "_BIG_C_MIN", 48)
    monkeypatch.setenv("MVDF_BLOCK_SINGLE", "1")
    monkeypatch.setenv("MVDF_BLOCK_BIGC", "1")
    calls = []
    for form, (plain, launch, counter) in list(K3._FORMS.items()):
        counted = lambda *a, _f=form, _p=plain: calls.append(_f) or _p(*a)
        monkeypatch.setitem(K3._FORMS, form, (counted, launch, counter))
    jm = pair["jm"]
    p = dict(pair, apply_cfg=jax.jit(lambda prm, *a: jm.apply(prm, *a, method=JViewFusion.apply_model_cfg)))
    out, ref = _run_both(p, pair["model"], pair["flat"])
    # 5 sites at each of 16^2 and 8^2 (1 in the input blocks, 2 x 2 in the output blocks)
    assert sorted(calls) == ["big"] * 5 + ["single"] * 5, calls
    rel_close(out, ref)


def test_chip_smoke_forms_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's forms phase at the tiny config on the CPU, with the
    big-C form lowered to C=64 so that both switched forms run: the same
    control flow and checks as on the card, minus the launch counts; the
    switches are off again afterwards."""
    import importlib.util
    import os
    from pathlib import Path

    from mvdfusion_tpu_torch.nn.viewfusion import ViewFusionConfig

    monkeypatch.setattr(K3, "_BIG_C_MIN", 48)
    for var in ("MVDF_BLOCK_SINGLE", "MVDF_BLOCK_BIGC"):
        monkeypatch.delenv(var, raising=False)
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    calls = []
    for form, (plain, launch, counter) in list(K3._FORMS.items()):
        counted = lambda *a, _f=form, _p=plain: calls.append(_f) or _p(*a)
        monkeypatch.setitem(K3._FORMS, form, (counted, launch, counter))
    assert chip_smoke.run_forms(2, "cpu", device="cpu", cfg=ViewFusionConfig().tiny()) == {}
    assert {"single", "big"} <= set(calls)
    assert not any(os.environ.get(v) for v in ("MVDF_BLOCK_SINGLE", "MVDF_BLOCK_BIGC"))
