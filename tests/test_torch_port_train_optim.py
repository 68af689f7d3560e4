"""The port's optimizer against the JAX package's trainer (optax) at the
tiny config, fp32 on the CPU: three AdamW updates with weight decay, the
global-norm clip, accumulation 2, a cosine lr and the EMA, and the skip on
non-finite gradients. Both trainers get the same synthetic gradients (the
JAX step through a loss whose gradient they are; the port's as
scene_batch_loss's), so the tests hold the update rule alone.

Tolerance: each parameter and EMA leaf max|diff| <= 1e-3 x max|JAX leaf|
(fp32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.pipeline.trainer as jtrainer
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.pipeline import trainer



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs (restored after): beside
    the suite's other workers, more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)

def close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max|diff| {err:.3e} vs tolerance {tol * scale:.3e}"


def nest(flat):
    tree = {}
    for path, leaf in flat.items():
        d = tree
        *head, last = path.split("/")
        for p in head:
            d = d.setdefault(p, {})
        d[last] = jnp.asarray(leaf)
    return {"params": tree}


def leaf(tree, fp):
    for k in ("params",) + tuple(fp):
        tree = tree[k]
    return np.asarray(tree, np.float32)


def _tiny():
    return randomize_(ViewFusion(ViewFusionConfig().tiny(), device="cpu"), seed=0)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig().tiny(), fuse_mode="never")
    table = viewfusion_mapping(jcfg)
    sd = {k: v.detach().numpy() for k, v in _tiny().state_dict().items()}
    params = nest({"/".join(fp): TRANSFORMS[tf](sd[tk]).astype(np.float32) for fp, (tk, tf) in table.items()})
    return dict(jm=JViewFusion(jcfg), table=table, params=params)


def _synthetic_grads(setup, calls, seed, nan_at=None):
    """Per call, a JAX gradient tree and the port's gradients by name (the
    JAX leaves mapped back: a leaf the mapping splits, qkv, is assembled
    from its parts), scaled so the global norm exceeds the clip."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(calls):
        flat = {}
        for fp in setup["table"]:
            shape = leaf(setup["params"], fp).shape
            flat["/".join(fp)] = (3.0 * rng.normal(size=shape)).astype(np.float32)
        if nan_at is not None and i == nan_at:
            k = next(k for k in flat if k.startswith("view_attn"))
            flat[k][(0,) * flat[k].ndim] = np.nan
        port = {}
        for fp, (tk, tf) in setup["table"].items():
            port.setdefault(tk, []).append((tf, flat["/".join(fp)]))
        out.append((nest(flat), {tk: _unmap(parts) for tk, parts in port.items()}))
    return out


def _unmap(parts):
    """The torch-layout tensor whose TRANSFORMS give `parts`."""
    kinds = [tf for tf, _ in parts]
    if kinds == ["none"]:
        return torch.tensor(parts[0][1])
    if kinds == ["linear"]:
        return torch.tensor(parts[0][1].T.copy())
    if kinds == ["conv"]:
        return torch.tensor(np.transpose(parts[0][1], (3, 2, 0, 1)).copy())
    if kinds == ["conv1x1"]:
        return torch.tensor(parts[0][1].T.copy()[:, :, None, None])
    d = dict(parts)
    if "qkv_q" in d:
        return torch.tensor(np.concatenate([d["qkv_q"].T, d["qkv_k"].T, d["qkv_v"].T]))
    return torch.tensor(np.concatenate([d["qkvb_q"], d["qkvb_k"], d["qkvb_v"]]))


def _run_both(setup, monkeypatch, tc_kw, grads):
    """Both train steps over `grads` (one call each) from the same start.
    Returns the port's model and state and the JAX state after the last
    call, and after each call the port's parameters (cloned) and counters
    and the JAX state."""
    model = _tiny()
    tc, jtc = trainer.TrainConfig(**tc_kw), jtrainer.TrainConfig(**tc_kw)

    def loss_and_grads(m, batch, generator=None, draws=None):
        return torch.zeros(()), {n: batch["g"][n].clone() for n, p in m.named_parameters() if p.requires_grad}

    monkeypatch.setattr(trainer, "scene_batch_loss", loss_and_grads)
    monkeypatch.setattr(jtrainer, "scene_batch_loss",
                        lambda m, p, b, r: sum(jnp.vdot(a, g) for a, g in
                                               zip(jax.tree.leaves(p), jax.tree.leaves(b["g"]))))
    state = trainer.init_train_state(model, tc)
    jstate = jtrainer.init_train_state(setup["params"], jtc)
    jstep = jax.jit(jtrainer.make_train_step(setup["jm"], jtc))
    trace = []
    for jg, tg in grads:
        trainer.train_step(model, state, {"g": tg}, tc)
        jstate, _ = jstep(jstate, {"g": jg}, jax.random.PRNGKey(0))
        trace.append(({n: p.detach().clone() for n, p in model.named_parameters()},
                      {k: v for k, v in state.opt_state.items() if not isinstance(v, dict)}, jstate))
    return model, state, jstate, trace


def _hold(setup, tensors, jtree, tol=1e-3):
    for fp, (tk, tf) in setup["table"].items():
        close(TRANSFORMS[tf](tensors[tk].detach().float().numpy()), leaf(jtree, fp), tol)


def test_three_optimizer_steps_match_optax(setup, monkeypatch):
    """Six calls at grad_accum_step 2 (three AdamW updates) with weight decay
    0.1, the global-norm clip at 1 (every update clips), a cosine lr over 4
    updates and EMA 0.9: every parameter (the frozen set unchanged) and every
    EMA leaf against the JAX trainer's after the sixth call."""
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, grad_accum_step=2, lr_schedule="cosine",
              lr_decay_steps=4, lr_alpha=0.1, ema_decay=0.9)
    start = {n: p.detach().clone() for n, p in _tiny().named_parameters()}
    model, state, jstate, _ = _run_both(setup, monkeypatch, kw, _synthetic_grads(setup, 6, seed=1))
    assert state.opt_state["count"] == 3 and state.step == 6 and int(jstate.step) == 6
    params = dict(model.named_parameters())
    _hold(setup, params, jstate.params)
    _hold(setup, state.ema, jstate.ema)
    mask = trainer.trainable_mask(model, trainer.TrainConfig(**kw))
    assert all(torch.equal(params[n], start[n]) for n in params if not mask[n])
    assert all(not torch.equal(params[n], start[n]) for n in params if mask[n])


def test_nonfinite_gradient_skips_the_update(setup, monkeypatch):
    """skip_nonfinite: a call with a NaN gradient leaves the parameters and
    AdamW's state as they were (its count too); the next finite call
    updates; both as optax.apply_if_finite does."""
    kw = dict(lr=1e-2, skip_nonfinite=True)  # accumulation 1: optax's MultiSteps keeps a NaN in its accumulator
    grads = _synthetic_grads(setup, 2, seed=2, nan_at=0)
    start = {n: p.detach().clone() for n, p in _tiny().named_parameters()}
    model, state, jstate, trace = _run_both(setup, monkeypatch, kw, grads)
    (first, counts, jfirst), _ = trace
    assert counts["count"] == 0 and counts["notfinite_count"] == 1
    assert all(torch.equal(p, start[n]) for n, p in first.items())
    assert int(jfirst.opt_state.notfinite_count) == 1
    assert state.opt_state["count"] == 1 and state.opt_state["notfinite_count"] == 0
    _hold(setup, dict(model.named_parameters()), jstate.params)
