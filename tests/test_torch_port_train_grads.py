"""The port's trainer against the JAX package's at the tiny config, fp32 on
the CPU: scene_batch_loss's gradients over 2 scenes against jax.grad per
leaf (through convert/mapping.py's tables), the same gradient in bf16
compute copies summed over scenes in fp32, trainable_mask for each
finetune flag, and frozen_master_dtype's masters.

Tolerances: the loss 1e-4 x max(1, |JAX|); each gradient leaf max|diff| <=
1e-3 x max|JAX leaf| (fp32 sums in another order), except the leaves whose
gradient the model's structure makes zero, held to 1e-6 x the largest
gradient on both sides; bf16 against fp32 as BF16_* below states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mvdfusion_tpu.pipeline.trainer as jtrainer
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.pipeline import trainer

S, IMG, N_SCENES = 4, 64, 2
# bf16 compute copies against fp32 ones on the same masters and draws: the
# loss relative to |fp32|; all gradients together, |g16 - g32| / |g32| in
# the L2 norm; each leaf, max|diff| <= RTOL x its max|g32| or FLOOR x the
# largest max|g32| of any leaf (the floor of a gradient the structure makes
# zero or near it), as chip_smoke.py's train phase holds "model" to "never"
BF16_LOSS_RTOL, BF16_GRAD_NORM_RTOL, BF16_GRAD_RTOL, BF16_GRAD_FLOOR = 1e-2, 1e-1, 0.25, 1e-2



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


def _tiny(dtype=torch.float32, **kw):
    cfg = dataclasses.replace(ViewFusionConfig().tiny(), drop_conditions=True, dtype=dtype, **kw)
    return randomize_(ViewFusion(cfg, device="cpu"), seed=0)


@pytest.fixture(scope="module")
def setup():
    model = _tiny()
    jcfg = dataclasses.replace(JConfig().tiny(), drop_conditions=True, fuse_mode="never")
    table = viewfusion_mapping(jcfg)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = nest({"/".join(fp): TRANSFORMS[tf](sd[tk]).astype(np.float32) for fp, (tk, tf) in table.items()})
    return dict(model=model, jm=JViewFusion(jcfg), jcfg=jcfg, table=table, params=params)


def _batch(n=N_SCENES):
    rng = np.random.default_rng(0)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    return dict(images=rng.uniform(size=(n, S, IMG, IMG, 3)).astype(np.float32),
                R=np.stack([R] * n).astype(np.float32), T=np.stack([T] * n).astype(np.float32),
                f=np.full((n, S, 2), 2.1875, np.float32), c=np.zeros((n, S, 2), np.float32),
                input_idx=np.array([[0], [2], [1]])[:n], target_idx=np.array([[1, 2, 3], [0, 1, 3], [0, 2, 3]])[:n])


def _jax_draws(key, B, cfg):
    rng_t, rng_noise, rng_attn, rng_drop = jax.random.split(key, 4)
    ls = cfg.latent_size
    t0 = int(jax.random.randint(rng_t, (), 0, cfg.timesteps))
    return dict(t=torch.full((B,), t0, dtype=torch.long),
                noise=torch.tensor(np.asarray(jax.random.normal(rng_noise, (B, ls, ls, 5)))),
                jitter_noise=torch.tensor(np.asarray(jax.random.normal(rng_attn, (B, ls, ls, cfg.n_pts_per_ray)))),
                drop=torch.tensor(np.asarray(jax.random.uniform(rng_drop, (B,)))))


def test_scene_batch_loss_gradients_match_jax_grad(setup):
    """The mean loss over 2 scenes and its gradient for every parameter,
    through the mapping, against jax.value_and_grad of the JAX package's
    scene_batch_loss with the same key; the frozen towers (VAE, CLIP) get no
    gradient on either side."""
    s = setup
    model, batch = s["model"], _batch()
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, g_ref = jax.jit(jax.value_and_grad(lambda p: jtrainer.scene_batch_loss(s["jm"], p, jb, key)))(
        s["params"])
    draws = [_jax_draws(k, 3, model.cfg) for k in jax.random.split(key, N_SCENES)]
    loss, grads = trainer.scene_batch_loss(model, {k: torch.as_tensor(v) for k, v in batch.items()}, draws=draws)
    close(loss, loss_ref, 1e-4)
    assert all(p.grad is None for p in model.parameters())
    top = max(np.abs(leaf(g_ref, fp)).max() for fp in s["table"])
    checked, zero, unused = 0, [], []
    for fp, (tk, tf) in s["table"].items():
        ref = leaf(g_ref, fp)
        if tk.split(".")[0] in ("vae", "clip_image_encoder"):
            assert grads[tk] is None and not ref.any(), tk
            continue
        if grads[tk] is None:  # a parameter the loss does not reach
            assert not ref.any(), tk
            unused.append(tk)
            continue
        got = TRANSFORMS[tf](grads[tk].numpy())
        if np.abs(ref).max() <= 1e-6 * top:
            # a gradient the model's structure makes zero, held to the fp32 noise floor on both sides
            assert np.abs(got).max() <= 1e-6 * top, tk
            zero.append(tk)
            continue
        close(got, ref, 1e-3)
        checked += 1
    assert checked > 200
    # the zero gradients are per-channel shifts: ahead of a GroupNorm of one channel a group (the tiny UNet's
    # 32-channel ResBlocks' out_layers and its final norm remove them exactly), or the pooling logits' bias
    # (a softmax ignores a shift)
    assert zero and all(z.endswith(".bias") or ".emb_layers." in z for z in zero), zero


def test_scene_batch_loss_sums_bf16_gradients_in_fp32():
    """The train step's gradient in bf16 compute copies (finetune_unet: every
    UNet weight trainable), over 3 scenes: bit-equal to the fp32 mean of
    each scene's bf16 gradient taken alone (no sum in bf16), and within the
    BF16_* tolerances of the same step on fp32 copies of the same masters
    and draws."""
    tc = trainer.TrainConfig(finetune_unet=True)
    batch = {k: torch.as_tensor(v) for k, v in _batch(3).items()}
    model16, model32 = _tiny(torch.bfloat16), _tiny(torch.float32)
    trainer.init_train_state(model16, tc)
    trainer.init_train_state(model32, tc)
    assert any(p.dtype == torch.bfloat16 and p.requires_grad for p in model16.parameters())
    g = torch.Generator().manual_seed(5)
    draws = [model32.loss_draws(3, torch.device("cpu"), g) for _ in range(3)]
    loss16, got = trainer.scene_batch_loss(model16, batch, draws=draws)
    alone = [trainer.scene_batch_loss(model16, {k: v[i : i + 1] for k, v in batch.items()}, draws=[draws[i]])[1]
             for i in range(3)]
    loss32, ref = trainer.scene_batch_loss(model32, batch, draws=draws)
    close(loss16, loss32, BF16_LOSS_RTOL)
    reached = [n for n, gn in got.items() if gn is not None]
    assert len(reached) > 200 and all(ref[n] is None for n in got if n not in reached)
    for n in reached:
        assert got[n].dtype == torch.float32
        assert torch.equal(got[n], (alone[0][n] + alone[1][n] + alone[2][n]) / 3), n
    norm = lambda gs: sum(float((g.double() ** 2).sum()) for g in gs) ** 0.5
    gap = norm(got[n] - ref[n] for n in reached) / norm(ref[n] for n in reached)
    assert gap <= BF16_GRAD_NORM_RTOL, gap
    top = max(float(ref[n].abs().max()) for n in reached)
    over = [n for n in reached if float((got[n] - ref[n]).abs().max())
            > max(BF16_GRAD_RTOL * float(ref[n].abs().max()), BF16_GRAD_FLOOR * top)]
    assert not over, over[:5]


@pytest.mark.parametrize("flags", [dict(), dict(finetune_unet=True), dict(finetune_projection=False),
                                   dict(finetune_cross_attn=False), dict(finetune_view_attn=False)],
                         ids=["default", "unet", "no-projection", "no-cross-attn", "no-view-attn"])
def test_trainable_mask_matches(setup, flags):
    s = setup
    tc, jtc = trainer.TrainConfig(**flags), jtrainer.TrainConfig(**flags)
    mask = trainer.trainable_mask(s["model"], tc)
    jmask = jtrainer.trainable_mask(s["params"], jtc)
    for fp, (tk, _) in s["table"].items():
        want = jmask["params"]
        for k in fp:
            want = want[k]
        assert mask[tk] == bool(want), (tk, "/".join(fp))
    assert 0 < sum(mask.values()) < len(mask)


def test_frozen_master_dtype(setup):
    """A bf16 model's masters: trainable leaves fp32, frozen matrices bf16,
    frozen vectors fp32 (the JAX package's rule per leaf, "auto"); under
    "float32" every master fp32. The compute copies are the parameters in
    their compute dtypes, the frozen bf16 masters the parameters themselves;
    the trainable set alone requires gradients."""
    jtc = jtrainer.TrainConfig()
    jm = JViewFusion(dataclasses.replace(setup["jcfg"], dtype=jnp.bfloat16))
    jstate = jtrainer.init_train_state(setup["params"], jtc, jm)
    model = _tiny(torch.bfloat16)
    dts = model.compute_dtypes()
    state = trainer.init_train_state(model, trainer.TrainConfig())
    mask = trainer.trainable_mask(model, trainer.TrainConfig())
    params = dict(model.named_parameters())
    for fp, (tk, _) in setup["table"].items():
        want = jnp.dtype(leaf_dtype(jstate.params, fp)).name
        assert str(state.params[tk].dtype).removeprefix("torch.") == want, tk
        assert params[tk].dtype == dts[tk] and params[tk].requires_grad == mask[tk]
        if not mask[tk] and state.params[tk].dtype == dts[tk]:
            assert state.params[tk] is params[tk]
    state32 = trainer.init_train_state(_tiny(torch.bfloat16), trainer.TrainConfig(frozen_master_dtype="float32"))
    assert all(t.dtype == torch.float32 for t in state32.params.values())


def leaf_dtype(tree, fp):
    for k in ("params",) + tuple(fp):
        tree = tree[k]
    return tree.dtype
