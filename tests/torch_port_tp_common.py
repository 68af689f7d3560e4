"""Shared pieces of the port's tensor- and view-parallel tests
(tests/test_torch_port_tp.py, test_torch_port_sp.py, test_torch_port_tp_cli.py):
the tiny model, the inputs every rank reads (tests/torch_port_tp_worker.py),
one rank's train step without a mesh, and the comparisons."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.pipeline import trainer
from test_torch_port_parallel import _jax_draws, run_ranks

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "torch_port_tp_worker.py")
S, IMG, B = 4, 64, 3  # views a scene, 64^2 images -> 16^2 latents, 3 targets
GRAD_CLIP = 1e-3  # below the tiny model's gradient norm: the clip acts


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tiny():
    return randomize_(ViewFusion(dataclasses.replace(ViewFusionConfig().tiny(), drop_conditions=True),
                                 device="cpu"), seed=0)


def close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} vs tolerance {tol * scale:.3e}"


def adam_gap(m, m_ref, g, g_ref, lr):
    """max over elements of |m - m_ref| / the gap AdamW's first step explains
    from the two gradients: lr |g/(|g|+eps) - g'/(|g'|+eps)|, plus 18 x 2^-24
    lr for the two sides' roundings of the update and half an ulp of each
    master (chip_smoke.py's TP_UPDATE_ULPS rule): at most 1."""
    g, g_ref = g.double(), g_ref.double()
    eps = trainer._EPS
    explained = lr * (g / (g.abs() + eps) - g_ref / (g_ref.abs() + eps)).abs()
    ulp = lambda x: (torch.nextafter(x.abs(), torch.tensor(float("inf"))) - x.abs()).double()
    allow = explained + lr * 18 * 2.0**-24 + 0.5 * (ulp(m) + ulp(m_ref))
    return float(((m - m_ref).double().abs() / allow).max())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_in")
    rng = np.random.default_rng(0)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    batch = dict(images=rng.uniform(size=(2, S, IMG, IMG, 3)).astype(np.float32),
                 R=np.stack([R] * 2).astype(np.float32), T=np.stack([T] * 2).astype(np.float32),
                 f=np.full((2, S, 2), 2.1875, np.float32), c=np.zeros((2, S, 2), np.float32),
                 input_idx=np.array([[0], [2]]), target_idx=np.array([[1, 2, 3], [0, 1, 3]]))
    cfg = ViewFusionConfig().tiny()
    H = cfg.latent_size
    f, c = np.full((S, 2), 2.1875, np.float32), np.zeros((S, 2), np.float32)
    sample = dict(cams=(R[1:], T[1:], f[1:], c[1:]), in_cams=(R[:1], T[:1], f[:1], c[:1]),
                  in_lat=(rng.normal(size=(1, H, H, 5)) * 0.5).astype(np.float32),
                  clip_v=(rng.normal(size=(B, 1, cfg.context_dim + 28)) * 0.3).astype(np.float32),
                  init=rng.normal(size=(B, H, H, 5)).astype(np.float32),
                  step_noise=rng.normal(size=(2, B, H, H, 5)).astype(np.float32),
                  jitter=rng.normal(size=(2, B, H, H, 1)).astype(np.float32))
    key = jax.random.PRNGKey(3)
    draws = [_jax_draws(k, B, cfg) for k in jax.random.split(key, 2)]
    t = lambda a: tuple(torch.as_tensor(np.asarray(x, np.float32)) for x in a) if isinstance(a, tuple) \
        else torch.as_tensor(a)
    data = dict(batch={k: torch.as_tensor(v) for k, v in batch.items()}, draws=draws,
                sample={k: t(v) for k, v in sample.items()}, grad_clip=GRAD_CLIP)
    torch.save(data, tmp / "in.pt")
    return dict(path=tmp / "in.pt", data=data, np_batch=batch, np_sample=sample, key=key)


def _one_rank(data, tc):
    """The step on one rank without a mesh: loss, the optimizer's gradient,
    the clip's norm, the masters."""
    model = _tiny()
    seen = []
    update = trainer._optimizer_update

    def spy(model, state, tc, grads):
        names = list(grads)
        seen.append(dict(grads={n: g.clone() for n, g in grads.items()},
                         norm=trainer.global_norm(model, state, names, [grads[n] for n in names])))
        return update(model, state, tc, grads)

    trainer._optimizer_update = spy
    try:
        state = trainer.init_train_state(model, tc)
        loss = trainer.train_step(model, state, data["batch"], tc, draws=data["draws"])
    finally:
        trainer._optimizer_update = update
    return dict(loss=loss, masters={n: t.detach().clone() for n, t in state.params.items()}, **seen[0])




def run_workers(inputs, out, dp, sp, tp):
    """The worker on dp x sp x tp ranks; their results in rank order."""
    run_ranks([[WORKER, str(dp), str(sp), str(tp), str(inputs["path"]), str(out)]] * (dp * sp * tp))
    return [torch.load(f"{out}{r}.pt") for r in range(dp * sp * tp)]
