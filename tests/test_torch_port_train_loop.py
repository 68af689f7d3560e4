"""The port's training loop and its kernel plumbing on the CPU, tiny config:
the scene sampler and the prefetch against the JAX package's, a checkpoint
and its resume against an unbroken run, the train CLI on a fake GSO
directory, the kernel-off switch on every route, the autograd Functions of
the kernel entry points (each launcher replaced by a stand-in that breaks
the graph), the launchers' refusal of inputs that need a gradient, the
prepared weights after an optimizer step, and a CPU rehearsal of
chip_smoke.py's train phase.

Comparisons are exact (torch.equal) where both sides run the same
operations on the same values; the switch's whole-model run against the
default CPU path, which differ in where fp32 sums round, at 1e-4 x max(1,
max|ref|).
"""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mvdfusion_tpu_torch.core.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from mvdfusion_tpu_torch.geometry.cameras import Cameras, look_at_view_transform
from mvdfusion_tpu_torch.nn import unet as U
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.ops import _lib
from mvdfusion_tpu_torch.ops import attention as K2
from mvdfusion_tpu_torch.ops import block as K3
from mvdfusion_tpu_torch.ops import conv3x3 as K8
from mvdfusion_tpu_torch.ops import crossview as K4
from mvdfusion_tpu_torch.ops import groupnorm as GN
from mvdfusion_tpu_torch.pipeline import trainer

REPO = Path(__file__).resolve().parents[1]



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs (restored after): beside
    the suite's other workers, more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _rnd(seed=0):
    g = torch.Generator().manual_seed(seed)
    return lambda *s, std=1.0, dt=torch.float32: (torch.randn(*s, generator=g) * std).to(dt)


def _tiny(**kw):
    return randomize_(ViewFusion(dataclasses.replace(ViewFusionConfig().tiny(), **kw), device="cpu"), seed=0)


def _batch(n=1, S=4, seed=0):
    rng = np.random.default_rng(seed)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    return dict(images=torch.tensor(rng.uniform(size=(n, S, 64, 64, 3)).astype(np.float32)),
                R=torch.tensor(np.stack([R] * n)).float(), T=torch.tensor(np.stack([T] * n)).float(),
                f=torch.full((n, S, 2), 2.1875), c=torch.zeros(n, S, 2),
                input_idx=torch.tensor([[0]] * n), target_idx=torch.tensor([[1, 2, 3]] * n))


# ------------------------------------------------------------- data
def test_sampler_and_prefetch_match_jax():
    from mvdfusion_tpu.data.prefetch import PrefetchIterator as JPrefetch
    from mvdfusion_tpu.data.sampler import StatefulShardedSampler as JSampler
    from mvdfusion_tpu_torch.data.prefetch import PrefetchIterator
    from mvdfusion_tpu_torch.data.sampler import StatefulShardedSampler

    for n, bs, start in ((7, 3, 0), (7, 3, 1), (7, 3, 5), (4, 4, 2), (2, 4, 0)):
        ours, ref = StatefulShardedSampler(n, bs, seed=5, start_step=start), JSampler(n, bs, seed=5, start_step=start)
        assert ours.steps_per_epoch == ref.steps_per_epoch
        for epoch in range(3):
            assert list(ours.epoch(epoch)) == list(ref.epoch(epoch))
            ours.reset_offset()
            ref.reset_offset()
    fetch = lambda i: {"i": i, "sq": i * i}
    assert list(PrefetchIterator(range(9), fetch, depth=2)) == list(JPrefetch(range(9), fetch, depth=2))
    it = iter(PrefetchIterator(range(100), fetch, depth=2))
    assert next(it) == {"i": 0, "sq": 0}
    it.close()  # an abandoned epoch stops its producer

    def bad(i):
        if i == 3:
            raise ValueError("scene 3")
        return i

    with pytest.raises(ValueError, match="scene 3"):
        list(PrefetchIterator(range(9), bad))


# ------------------------------------------------------ checkpoint, resume
def _state_equal(a, b):
    assert a.step == b.step
    assert all(torch.equal(a.params[n], b.params[n]) for n in a.params)
    for k, v in a.opt_state.items():
        if isinstance(v, dict):
            assert all(torch.equal(v[n], b.opt_state[k][n]) for n in v), k
        else:
            assert v == b.opt_state[k], k
    assert (a.ema is None) == (b.ema is None)
    if a.ema is not None:
        assert all(torch.equal(a.ema[n], b.ema[n]) for n in a.ema)


def test_checkpoint_then_resume_equals_an_unbroken_run(tmp_path):
    """Three calls at grad_accum_step 2 with EMA in one run, and the same
    calls broken after the second by save_checkpoint / restore into a fresh
    model and state: the same parameters, optimizer state and EMA, bit for
    bit; `latest` names the newest save."""
    tc = trainer.TrainConfig(lr=1e-2, grad_accum_step=2, ema_decay=0.9, weight_decay=0.1)
    batches = [_batch(seed=i) for i in range(3)]
    gen = lambda i: torch.Generator().manual_seed(100 + i)
    model = _tiny()
    state = trainer.init_train_state(model, tc)
    for i in range(3):
        trainer.train_step(model, state, batches[i], tc, gen(i))
    model2 = _tiny()
    state2 = trainer.init_train_state(model2, tc)
    for i in range(2):
        trainer.train_step(model2, state2, batches[i], tc, gen(i))
    save_checkpoint(tmp_path, 1, {"dummy": torch.zeros(1), "step": 1, "epoch": 0})
    path = save_checkpoint(tmp_path, 2, trainer.state_payload(state2, epoch=0))
    assert latest_checkpoint(tmp_path) == path and (tmp_path / "latest").read_text() == "step_00000002"
    model3 = _tiny()
    state3 = trainer.init_train_state(model3, tc)
    assert trainer.restore_state(model3, state3, restore_checkpoint(path)) == 0
    trainer.train_step(model3, state3, batches[2], tc, gen(2))
    _state_equal(state3, state)
    p3, p1 = dict(model3.named_parameters()), dict(model.named_parameters())
    assert all(torch.equal(p3[n], p1[n]) for n in p1)
    assert latest_checkpoint(tmp_path / "absent") is None


# ------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def fake_gso(tmp_path_factory):
    root = tmp_path_factory.mktemp("gso")
    CS.write_gso(root, 2, 64, seed=0)
    return root


def _cli_config(tmp_path, gso, exp, **saver):
    import yaml

    cfg = yaml.safe_load((REPO / "configs" / "train.yaml").read_text())
    cfg["dataset"] = {"target": "gso", "params": {"root": str(gso), "subset": "test", "image_size": 64}}
    cfg["trainer"].update(epochs=4, train_batch_size=3, grad_accum_step=2, scenes_per_chip=1)
    cfg["saver"] = dict(exp_dir=str(exp) + "/", print_interval=1, save_interval=1, vis_interval=2, vis_ddim_steps=1,
                        loss_interval=1, **saver)
    p = tmp_path / f"{exp.name}.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def test_train_cli_on_fake_gso(tmp_path, fake_gso):
    """Three steps (grad_accum_step 2, one scene a step, two scenes an
    epoch): a checkpoint a step and `latest`, the vis grid at step 2 and the
    loss plot; the same three steps as 2 + a resumed 1 give the same
    checkpoint bit for bit (the epoch boundary falls between them); the
    regression preview writes its grid; a tp layout larger than the ranks
    raises, and --multihost outside a torchrun launch."""
    from mvdfusion_tpu_torch.cli.train import main

    base = ["--tiny", "--device", "cpu", "--seed", "3"]
    a = tmp_path / "a"
    model, state = main(["-c", _cli_config(tmp_path, fake_gso, a)] + base + ["--max-steps", "3"])
    assert state.step == 3 and state.opt_state["count"] == 1
    assert sorted(os.listdir(a / "ckpt")) == ["latest"] + [f"step_{i:08d}" for i in (1, 2, 3)]
    assert (a / "ckpt" / "latest").read_text() == "step_00000003"
    assert (a / "vis" / "0000002.jpg").stat().st_size > 0 and (a / "loss" / "loss.png").stat().st_size > 0
    from PIL import Image

    assert Image.open(a / "vis" / "0000002.jpg").size == (3 * 64, 5 * 64)  # 3 targets; rows noise..gt depth
    b = tmp_path / "b"
    cfg_b = _cli_config(tmp_path, fake_gso, b)
    main(["-c", cfg_b] + base + ["--max-steps", "2"])
    _, state_b = main(["-c", cfg_b] + base + ["--max-steps", "1"])
    assert state_b.step == 3
    ra, rb = restore_checkpoint(a / "ckpt" / "step_00000003"), restore_checkpoint(b / "ckpt" / "step_00000003")
    assert ra["epoch"] == rb["epoch"] == 1 and ra["step"] == rb["step"] == 3
    assert all(torch.equal(ra["params"][n], rb["params"][n]) for n in ra["params"])
    assert all(torch.equal(ra["opt_state"]["mu"][n], rb["opt_state"]["mu"][n]) for n in ra["opt_state"]["mu"])
    c = tmp_path / "c"
    main(["-c", _cli_config(tmp_path, fake_gso, c, regression=True)] + base + ["--max-steps", "2"])
    assert (c / "vis" / "0000002.jpg").stat().st_size > 0
    # --tp runs (tests/test_torch_port_tp_cli.py); a layout larger than the ranks raises
    from mvdfusion_tpu_torch.parallel import make_mesh

    for dp, tp in ((2, 2), (1, 2)):
        with pytest.raises(ValueError, match="needs more than"):
            make_mesh(dp=dp, tp=tp, world=1)
    with pytest.raises(RuntimeError, match="torchrun"):  # --multihost outside a torchrun launch
        main(["-c", cfg_b, "--device", "cpu", "--multihost"])


# ------------------------------------------------------- kernel-off switch
def test_kernel_route_and_switch(monkeypatch):
    """The launch-or-plain decision is a function of (device type, switch);
    MVDF_DISABLE_PALLAS is read when called and any non-empty value sets it
    (as the reference's test); plain_versions() sets it and restores; under
    it every gate closes."""
    monkeypatch.delenv(_lib.SWITCH, raising=False)
    assert _lib.kernel_route("cuda", False) and not _lib.kernel_route("cuda", True)
    assert not _lib.kernel_route("cpu", False) and not _lib.kernel_route("cpu", True)
    assert _lib.kernel_route("cuda") and not _lib.switched_off()
    monkeypatch.setenv(_lib.SWITCH, "0")
    assert _lib.switched_off() and not _lib.kernel_route("cuda")
    monkeypatch.delenv(_lib.SWITCH)
    with _lib.plain_versions():
        assert not _lib.kernel_route("cuda")
        q = torch.zeros(1, 512, 2, 64)
        assert not K2.should_fuse_attention(q, q)
        assert not GN.should_fuse_gn((2, 32, 32, 320), 32)
        assert {GN.gn_route((2, 256, 256, 128), 32, d, g) for d in ("cuda", "cpu") for g in (True, False)} == {"plain"}
        assert not K3.should_fuse_block(320, 1024, 8) and K3.block_route(16, 1024, 320, 8, 1280) is None
        assert not K4.should_fuse_crossview(8, 32, 32, 256)
        monkeypatch.setenv("MVDF_CONV3X3", "1")
        assert not K8.should_fuse_conv3x3((8, 64, 64, 256))
    assert not _lib.switched_off()
    assert K2.should_fuse_attention(q, q) and GN.gn_route((2, 256, 256, 128), 32, "cuda") == "k7"
    assert K3.block_route(16, 1024, 320, 8, 1280) == "split" and K8.should_fuse_conv3x3((8, 64, 64, 256))
    monkeypatch.setenv(_lib.SWITCH, "1")
    with _lib.plain_versions():
        pass
    assert os.environ[_lib.SWITCH] == "1"


def _cases(rnd):
    """(name, entry, plain, inputs, [(module or dict, attr or key, stand-in)])
    for every kernel entry point at small CPU shapes; each stand-in computes
    the plain version under no_grad, as a kernel's output has no graph."""
    def standin(f):
        def run(*a, **k):
            _lib.no_graph("stand-in", *(t for t in a if isinstance(t, torch.Tensor)))
            CALLS.append(1)
            with torch.no_grad():
                return f(*a, **k)
        return run

    gn = lambda route: (lambda x, w, b: GN.group_norm_act(x, w, b, 32, 1e-5, "silu", route))
    gnp = lambda f: (lambda x, w, b: f(x, w, b, 32, 1e-5, "silu"))
    gn_in = [rnd(2, 64, 64), 1 + rnd(64, std=0.1), rnd(64, std=0.1)]
    cases = [
        ("K2", lambda q, k, v: K2.fused_attention(q, k, v, 8**-0.5), lambda q, k, v: K2.attention_plain(q, k, v, 8**-0.5),
         [rnd(2, 64, 2, 8) for _ in range(3)],
         [(K2, "launch_attention", standin(lambda q, k, v, s, mode=None, out=None: K2.attention_plain(q, k, v, s, mode)))]),
        ("K1", gn("k1"), gnp(GN.group_norm_plain), gn_in,
         [(GN, "launch_group_norm", standin(lambda x, w, b, g, e, a="none", **_: GN.group_norm_plain(x, w, b, g, e, a)))]),
        ("K7", gn("k7"), gnp(GN.group_norm_tiled_plain), [t.clone() for t in gn_in],
         [(GN, "launch_group_norm_tiled", standin(GN.group_norm_tiled_plain))]),
    ]
    for form in ("split", "single", "big"):
        x, a2, w = CS.site_inputs(rnd, 2, 64, 32, torch.float32, a2_map=form == "single")
        plain, _, counter = K3._FORMS[form]
        launch = standin(lambda x, a2, w, heads, plain=plain: plain(
            x, a2, K3.unprepared_site_weights(w) if isinstance(w, K3.PreparedSite) else w, heads))
        cases.append((f"site {form}", lambda x, a2, *t, form=form: K3.transformer_block(x, a2, K3.BlockWeights(*t), 4, form),
                      lambda x, a2, *t, plain=plain: plain(x, a2, K3.BlockWeights(*t), 4), [x, a2, *w],
                      [(K3._FORMS, form, (plain, launch, counter))]))
    for name, launcher, plain in (("K4", "launch_crossview", K4.crossview_plain),
                                  ("K4b", "launch_crossview_two_phase", K4.crossview_two_phase_plain)):
        args, *_ = CS.cv_inputs(K4, rnd, "cpu", 3, 4, 16, 2, 2, 8, torch.float32)
        xy, pts, centers, mask, b_acc, maps_p, kg, w, heads, freqs = args
        L = len(w.qkv_w)
        patches = [(K4, launcher, standin(plain))]
        if name == "K4b":
            patches.append((K4, "_SINGLE_KERNEL_MAPS_BYTES", 0))
        cases.append((name, lambda *t, L=L: K4.crossview_aggregate(*t[:6], *K4._unflat_weights(t[6:], L, 0), 2, freqs),
                      lambda *t, L=L, plain=plain: plain(*t[:6], *K4._unflat_weights(t[6:], L, 0), 2, freqs),
                      [xy, pts, centers, mask, b_acc, maps_p, *K4._flat_weights(kg, w)], patches))
    unpack = lambda w9: w9.reshape(3, 3, w9.shape[0] // 9, -1).permute(3, 2, 0, 1)
    cases.append(("K8", K8.gn_silu_conv3x3, K8.conv3x3_plain,
                  [rnd(1, 8, 8, 16), 1 + rnd(1, 16, std=0.1), rnd(1, 16, std=0.1), rnd(16, 16, 3, 3, std=1 / 12),
                   rnd(16, std=0.1), rnd(1, 16, std=0.1), rnd(1, 8, 8, 16)],
                  [(K8, "launch_conv3x3", standin(lambda x, a, b, w9, bias, row, res=None, act="silu":
                                                  K8.conv3x3_plain(x, a, b, unpack(w9), bias, row, res, act)))]))
    return cases


CALLS: list = []
CASE_NAMES = ("K2", "K1", "K7", "site split", "site single", "site big", "K4", "K4b", "K8")


def _patch(monkeypatch, patches):
    monkeypatch.setattr(_lib, "launches", lambda t: _lib.kernel_route("cuda"))  # every tensor as if on the card
    for owner, attr, value in patches:
        if isinstance(owner, dict):
            monkeypatch.setitem(owner, attr, value)
        else:
            monkeypatch.setattr(owner, attr, value)
    CALLS.clear()
    _lib.reset_launches()


@pytest.mark.parametrize("name", CASE_NAMES)
def test_function_gradients_are_the_plain_versions(monkeypatch, name):
    """Each entry point on its kernel route, the launcher a stand-in whose
    output has no graph: the output has a grad_fn, the launch is counted,
    and every input gradient equals the plain version's own autograd bit for
    bit (the backward is that autograd on the saved inputs)."""
    monkeypatch.delenv(_lib.SWITCH, raising=False)
    _, entry, plain, inputs, patches = next(c for c in _cases(_rnd(CASE_NAMES.index(name))) if c[0] == name)
    _patch(monkeypatch, patches)
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = entry(*leaves)
    assert out.grad_fn is not None and CALLS == [1] and sum(_lib.LAUNCHES.values()) == 1
    ref = plain(*leaves)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    got, want = torch.autograd.grad(out, leaves, g, allow_unused=True), torch.autograd.grad(ref, leaves, g,
                                                                                         allow_unused=True)
    assert any(w is not None for w in want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_switch_takes_every_entry_point_to_its_plain_version(monkeypatch, name):
    """Each entry point as if on the card: its launcher runs once without the
    switch, never under it (MVDF_DISABLE_PALLAS=1), where the output is the
    plain version's and no launch is counted."""
    _, entry, plain, inputs, patches = next(c for c in _cases(_rnd(CASE_NAMES.index(name))) if c[0] == name)
    _patch(monkeypatch, patches)
    monkeypatch.delenv(_lib.SWITCH, raising=False)
    with torch.no_grad():
        entry(*inputs)
        assert CALLS == [1]
        CALLS.clear()
        _lib.reset_launches()
        monkeypatch.setenv(_lib.SWITCH, "1")
        out = entry(*inputs)
        assert CALLS == [] and not _lib.LAUNCHES and torch.equal(out, plain(*inputs))


def test_switch_on_the_direct_routes(monkeypatch):
    """The GEMM and the folded GroupNorm statistics as if on the card: the
    plain version under the switch, the launcher without it."""
    monkeypatch.setattr(_lib, "launches", lambda t: _lib.kernel_route("cuda"))
    rnd = _rnd(3)
    a, w = rnd(64, 32), rnd(48, 32)
    monkeypatch.setenv(_lib.SWITCH, "1")
    assert torch.equal(K3.gemm(a, w), K3.gemm_plain(a, w))
    x, s, b = rnd(2, 64, 64), 1 + rnd(64), rnd(64)
    got = K8.gn_fold_affine(x, s, b, 32, 1e-6)
    assert all(torch.equal(p, q) for p, q in zip(got, K8.gn_fold_affine_plain(x, s, b, 32, 1e-6)))
    monkeypatch.delenv(_lib.SWITCH)
    called = []
    monkeypatch.setattr(K8, "launch_gn_fold_affine", lambda *args: called.append(1) or K8.gn_fold_affine_plain(*args))
    K8.gn_fold_affine(x, s, b, 32, 1e-6)
    assert called == [1] and _lib.LAUNCHES["gn_fold_affine"] == 1


def _launchers(rnd):
    """Every launcher with inputs of which one needs a gradient."""
    g = lambda t: t.requires_grad_(True)
    q = g(rnd(2, 64, 2, 8))
    x, w, b = g(rnd(2, 64, 64)), rnd(64), rnd(64)
    site_x, a2, site_w = CS.site_inputs(rnd, 2, 64, 32, torch.float32, a2_map=False)
    site_x.requires_grad_(True)
    args, *_ = CS.cv_inputs(K4, rnd, "cpu", 3, 4, 16, 2, 2, 8, torch.float32)
    xy, pts, centers, mask, b_acc, maps_p, kg, cw, heads, freqs = args
    maps_p.requires_grad_(True)
    h = g(rnd(24, 16))
    cx = g(rnd(1, 8, 8, 16))
    return {
        "launch_attention": lambda: K2.launch_attention(q, q, q, 0.3),
        "launch_group_norm": lambda: GN.launch_group_norm(x, w, b, 32, 1e-5),
        "launch_group_norm_tiled": lambda: GN.launch_group_norm_tiled(x, w, b, 32, 1e-5),
        "launch_fold": lambda: GN.launch_fold(x, w, b, 32, 1e-5, True),
        "launch_apply_affine": lambda: GN.launch_apply_affine(x, rnd(2, 64), rnd(2, 64)),
        "launch_gn_fold_affine": lambda: K8.launch_gn_fold_affine(x, w, b, 32, 1e-6),
        "launch_conv3x3": lambda: K8.launch_conv3x3(cx, rnd(1, 16), rnd(1, 16), rnd(144, 16), rnd(16), rnd(1, 16)),
        "layernorm": lambda: K3.layernorm(h),
        "launch_transformer_block": lambda: K3.launch_transformer_block(site_x, a2, site_w, 4),
        "launch_transformer_block_single": lambda: K3.launch_transformer_block_single(site_x, a2, site_w, 4),
        "launch_transformer_block_big": lambda: K3.launch_transformer_block_big(site_x, a2, site_w, 4),
        "launch_big_attention": lambda: K3.launch_big_attention(site_x, rnd(96, 32), 4),
        "launch_gather": lambda: K4.launch_gather(xy, pts, centers, mask, b_acc, maps_p, kg, freqs, "single"),
        "dit_layernorm": lambda: K4.dit_layernorm(h, rnd(16), rnd(16), torch.float32),
        "view_attention": lambda: K4.view_attention(h, rnd(48, 16), rnd(48), 3, 2),
        "launch_pool": lambda: K4.launch_pool(h, 8, 3, rnd(1, 16), rnd(1), torch.float32),
        "launch_crossview": lambda: K4.launch_crossview(*args),
        "launch_crossview_two_phase": lambda: K4.launch_crossview_two_phase(*args),
    }


LAUNCHERS = tuple(_launchers(_rnd()).keys())


@pytest.mark.parametrize("name", LAUNCHERS + ("gemm", "gn_fold_affine"))
def test_bare_launcher_under_grad_raises(monkeypatch, name):
    """A launcher (and the GEMM and gn_fold_affine, which has no gradient in
    the reference either, on their kernel routes) reached with an input that
    needs a gradient raises before it launches: a kernel's output would
    carry no graph. Under no_grad the same call passes the check."""
    monkeypatch.setattr(_lib, "launches", lambda t: True)
    rnd = _rnd(4)
    if name == "gemm":
        a = rnd(64, 32).requires_grad_(True)
        call = lambda: K3.gemm(a, rnd(48, 32))
    elif name == "gn_fold_affine":
        x = rnd(2, 64, 64).requires_grad_(True)
        call = lambda: K8.gn_fold_affine(x, rnd(64), rnd(64), 32, 1e-6)
    else:
        call = _launchers(rnd)[name]
    with pytest.raises(RuntimeError, match="drops the autograd graph"):
        call()
    with torch.no_grad(), pytest.raises(Exception) as info:
        call()  # past the check: on the CPU the launch itself fails
    assert "drops the autograd graph" not in str(info.value)


def test_prepared_weights_follow_an_optimizer_step(monkeypatch):
    """With the sites and GridAttn reading prepared weights (the card's
    route, forced on the CPU), a train step's update bumps the parameters'
    versions: the next forward rebuilds the prepared copies from the new
    values, and the train step's gradient reached the parameters."""
    monkeypatch.setattr(_lib, "reads_prepared", lambda t: True)
    model = _tiny()
    tc = trainer.TrainConfig(lr=1e-1, finetune_unet=True)
    state = trainer.init_train_state(model, tc)
    site = next(m for m in model.unet.modules() if isinstance(m, U.SpatialTransformer))
    params = U._site_params(site.norm, site.proj_in, site.proj_out, site.transformer_blocks[0])
    t0 = model.embed_time(torch.tensor([500]))[0].detach()
    with torch.no_grad():
        old_site = K3.prepared_site_weights(site, params, lambda: U._site_weights(params), torch.float32)
        _, old_agg = model.view_attn.kernel_weights(t0, prepared=True)
    before = site.proj_in.weight.detach().clone()
    trainer.train_step(model, state, _batch(), tc, torch.Generator().manual_seed(0))
    assert not torch.equal(site.proj_in.weight, before)
    with torch.no_grad():
        new_site = K3.prepared_site_weights(site, params, lambda: U._site_weights(params), torch.float32)
        _, new_agg = model.view_attn.kernel_weights(t0, prepared=True)
    assert new_site is not old_site and torch.equal(new_site.pi_w, site.proj_in.weight.reshape(new_site.pi_w.shape))
    assert new_agg.fin_w is not old_agg.fin_w and torch.equal(new_agg.fin_w, model.view_attn.final_layer_b.weight)


def test_apply_model_cfg_under_switch_launches_nothing(monkeypatch):
    """The tiny model with every tensor as if on the card and every launcher
    raising: under the switch apply_model_cfg launches nothing and matches
    the default CPU path at 1e-4 x max(1, max|ref|)."""
    model = _tiny().eval()
    rng = np.random.default_rng(3)
    B, H = 3, model.cfg.latent_size
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, B + 1) + 90)
    cams = lambda s: Cameras(torch.tensor(R[s]), torch.tensor(T[s]), torch.full((len(R[s]), 2), 2.1875),
                             torch.zeros(len(R[s]), 2))
    r = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    args = (r(B, H, H, 5), cams(slice(1, None)), r(1, H, H, 5), cams(slice(0, 1)), r(B, 1, model.cfg.context_dim + 28),
            torch.full((B,), 500), 2.5, r(B, H, H, 1))
    with torch.no_grad():
        ref = model.apply_model_cfg(*args)

    def boom(*a, **k):
        raise AssertionError("a kernel launched under the switch")

    monkeypatch.setattr(_lib, "launches", lambda t: _lib.kernel_route("cuda"))
    monkeypatch.setattr(_lib, "call", boom)
    _lib.reset_launches()
    with torch.no_grad(), _lib.plain_versions():
        out = model.apply_model_cfg(*args)
    assert not _lib.LAUNCHES
    err, scale = (out - ref).abs().max().item(), max(1.0, ref.abs().max().item())
    assert err <= 1e-4 * scale, err


def test_chip_smoke_train_rehearsal_on_cpu():
    """chip_smoke.py's train phase at the tiny config on the CPU: the CLI's
    optimizer step with its checkpoint and a one-step resume, the frozen
    parameters bit-equal, the modes' gap and the switch's whole-model gap
    within their tolerances (no launch counts or Function checks: no card)."""
    res = CS.run_train("cpu", 1, device="cpu", tiny=True)
    assert res["counts"] == {} and res["numerics"]["ok"] and res["numerics"]["plain_launches"] == 0
    assert res["gap"]["gap"] <= CS.TRAIN_MODE_LOSS_RTOL
    json.dumps({k: v for k, v in res.items() if k != "counts"}, default=str)


def test_unet_remat_gives_the_same_loss_and_gradients():
    """unet_remat recomputes each UNet block's interior in the backward
    (torch.utils.checkpoint): the same loss and parameter gradients as
    without it, bit for bit on the CPU."""
    draws = dict(t=torch.full((3,), 420), noise=_rnd(5)(3, 16, 16, 5), jitter_noise=_rnd(6)(3, 16, 16, 1),
                 drop=torch.tensor([0.5, 0.12, 0.03]))
    scene = [v[0] for v in _batch().values()]
    grads = []
    for remat in (False, True):
        model = _tiny(unet_remat=remat, drop_conditions=True)
        loss = model.p_losses(*scene, **draws)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in model.named_parameters() if p.grad is not None}))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1) and g0.keys() == g1.keys() and len(g0) > 100
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
