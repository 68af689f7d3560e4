"""The port's data parallelism (mvdfusion_tpu_torch/parallel/mesh.py and its
users) on the CPU, at the tiny config, ranks as OS processes over gloo:

(a) make_mesh's default dp, its (dp, sp, tp) shape and rank coordinates,
    and its size check against the JAX make_mesh.
(b) A two-rank train step, one scene a rank with the JAX side's draws of
    that scene: the gradient the optimizer reads (averaged over the ranks)
    and the loss against jax.value_and_grad of the JAX scene_batch_loss on
    both scenes, under test_torch_port_train_grads.py's tolerances; the
    masters after the step bit-equal to one rank's step on both scenes, a
    process of its own started as the ranks are. Every process here runs 2
    intra-op threads with OpenMP's and MKL's dynamic thread counts off
    (STATIC_THREADS), so the CPU's sums run in the same order on both
    sides: with MKL_DYNAMIC on (MKL's default where torch.set_num_threads
    is never called), MKL picks its threads by the host's load, and one
    process's sums came apart from another's under the suite's load.
(c) At grad_accum_step 2, the gradient averaged over the ranks once, at the
    optimizer step, against each call's averaged first (1e-6 x max|g|: the
    mean is linear, the two orders differ by fp32 rounding).
(d) cli.train on two ranks (--dp 2, parallel.spawn; and --multihost under a
    torchrun-style environment): rank 0 alone writes the checkpoints, both
    ranks resume from them, and 2 + a resumed 1 steps end where 3 unbroken
    steps end, bit for bit.
(e) cli.demo --multihost --scene-batch 2 on two ranks writes the files and
    the metrics.json of the one-process run, bit for bit (each rank runs one
    scene of a batch, as the one-process run does).

The ranks are launched as tests/test_multiprocess.py launches its pair: a
free port, one retry if the port was taken meanwhile, and a timeout.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import mvdfusion_tpu.pipeline.trainer as jtrainer
from mvdfusion_tpu.convert.mapping import TRANSFORMS, viewfusion_mapping
from mvdfusion_tpu.geometry.cameras import look_at_view_transform
from mvdfusion_tpu.nn.viewfusion import ViewFusion as JViewFusion
from mvdfusion_tpu.nn.viewfusion import ViewFusionConfig as JConfig
from mvdfusion_tpu.parallel.mesh import make_mesh as jmake_mesh
from mvdfusion_tpu_torch.core.checkpoint import restore_checkpoint
from mvdfusion_tpu_torch.nn.viewfusion import ViewFusion, ViewFusionConfig, randomize_
from mvdfusion_tpu_torch.parallel import make_mesh
from mvdfusion_tpu_torch.parallel.mesh import free_port, mesh_coords

REPO = Path(__file__).resolve().parents[1]
S, IMG = 4, 64  # views a scene, 64^2 images -> 16^2 latents with the tiny VAE
TIMEOUT = 600
# every process these tests start: no dynamic thread adjustment (MKL's is on
# by default until torch.set_num_threads is called)
STATIC_THREADS = dict(OMP_DYNAMIC="FALSE", MKL_DYNAMIC="FALSE")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads while this module runs (restored after): beside
    the suite's other workers, more threads only contend for the cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _launch(argvs, port):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(len(argvs)),
               LOCAL_WORLD_SIZE=str(len(argvs)), OMP_NUM_THREADS=str(2 * len(argvs)), **STATIC_THREADS)
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


def run_ranks(argvs):
    """Run one process a rank with torchrun's environment; returns their
    outputs, failing on a non-zero exit."""
    procs, outs = _launch(argvs, free_port())
    if any(p.returncode for p in procs) and any("address already in use" in o.lower() for o in outs):
        # free_port probes, then closes: another process may take the port in the gap
        procs, outs = _launch(argvs, free_port())
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


# ----------------------------------------------------------------- (a)
@pytest.mark.parametrize("n,dp", [(8, None), (8, 4), (4, None), (2, 2), (1, None), (8, 8)])
def test_make_mesh_dp_matches_jax(n, dp):
    ours = make_mesh(dp=dp, world=n)
    ref = jmake_mesh(dp=dp, devices=jax.devices()[:n])
    assert ours.dp == ref.shape["dp"] and (ours.tp, ours.sp, ours.world, ours.rank) == (1, 1, n, 0)


@pytest.mark.parametrize("n,dp", [(4, 5), (1, 2), (8, 9)])
def test_make_mesh_refuses_more_ranks_than_there_are(n, dp):
    with pytest.raises(AssertionError):
        jmake_mesh(dp=dp, devices=jax.devices()[:n])
    with pytest.raises(ValueError, match="needs more than"):
        make_mesh(dp=dp, world=n)


@pytest.mark.parametrize("n,dp,tp,sp", [(8, None, 2, 1), (8, None, 1, 2), (8, 2, 2, 2), (4, 1, 2, 2), (8, None, 4, 1),
                                         (8, 1, 2, 3), (8, 2, 1, 4)])
def test_make_mesh_tp_and_sp_match_jax(n, dp, tp, sp):
    """make_mesh(dp, tp, sp)'s shape and every rank's (d, s, t) against the
    JAX make_mesh's device grid (tp fastest, then sp, then dp); ranks past
    the layout have no coordinates."""
    devices = jax.devices()[:n]
    ref = jmake_mesh(dp=dp, tp=tp, sp=sp, devices=devices)
    shape = dict(ref.shape)
    grid = np.vectorize(lambda d: d.id)(ref.devices).reshape(shape["dp"], shape.get("sp", 1), shape["tp"])
    ours = make_mesh(dp=dp, tp=tp, sp=sp, world=n)
    assert (ours.dp, ours.sp, ours.tp, ours.world, ours.rank) == (shape["dp"], shape.get("sp", 1), shape["tp"], n, 0)
    for r in range(n):
        at = np.argwhere(grid == devices[r].id)
        coords = mesh_coords(r, ours.dp, ours.sp, ours.tp)
        assert coords == (tuple(int(i) for i in at[0]) if len(at) else None), (r, coords, at)
    assert ours.coords == mesh_coords(0, ours.dp, ours.sp, ours.tp)


@pytest.mark.parametrize("n,dp,tp,sp", [(4, 2, 2, 2), (8, 2, 4, 2), (8, 3, 3, 1)])
def test_make_mesh_tp_and_sp_refuse_more_ranks_than_there_are(n, dp, tp, sp):
    with pytest.raises(AssertionError):
        jmake_mesh(dp=dp, tp=tp, sp=sp, devices=jax.devices()[:n])
    with pytest.raises(ValueError, match="needs more than"):
        make_mesh(dp=dp, tp=tp, sp=sp, world=n)


# ------------------------------------------------------------ (b), (c)
def close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"max|diff| {err:.3e} vs tolerance {tol * scale:.3e}"


def _tiny():
    return randomize_(ViewFusion(dataclasses.replace(ViewFusionConfig().tiny(), drop_conditions=True),
                                 device="cpu"), seed=0)


def _batch():
    """test_torch_port_train_grads.py's two scenes."""
    rng = np.random.default_rng(0)
    R, T = look_at_view_transform(dist=1.5, elev=30.0, azim=np.linspace(0, 315, S) + 90)
    return dict(images=rng.uniform(size=(2, S, IMG, IMG, 3)).astype(np.float32),
                R=np.stack([R] * 2).astype(np.float32), T=np.stack([T] * 2).astype(np.float32),
                f=np.full((2, S, 2), 2.1875, np.float32), c=np.zeros((2, S, 2), np.float32),
                input_idx=np.array([[0], [2]]), target_idx=np.array([[1, 2, 3], [0, 1, 3]]))


def _jax_draws(key, B, cfg):
    rng_t, rng_noise, rng_attn, rng_drop = jax.random.split(key, 4)
    ls = cfg.latent_size
    t0 = int(jax.random.randint(rng_t, (), 0, cfg.timesteps))
    return dict(t=torch.full((B,), t0, dtype=torch.long),
                noise=torch.tensor(np.asarray(jax.random.normal(rng_noise, (B, ls, ls, 5)))),
                jitter_noise=torch.tensor(np.asarray(jax.random.normal(rng_attn, (B, ls, ls, cfg.n_pts_per_ray)))),
                drop=torch.tensor(np.asarray(jax.random.uniform(rng_drop, (B,)))))


def _leaf(tree, fp):
    for k in ("params",) + tuple(fp):
        tree = tree[k]
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def dp_step(tmp_path_factory):
    """The two ranks' results (tests/torch_port_parallel_worker.py), the JAX
    reference on both scenes and one rank's step on both scenes (the same
    worker at world size 1, a process started as the ranks are)."""
    tmp = tmp_path_factory.mktemp("dp_step")
    model = _tiny()
    jcfg = dataclasses.replace(JConfig().tiny(), drop_conditions=True, fuse_mode="never")
    table = viewfusion_mapping(jcfg)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree = {}
    for fp, (tk, tf) in table.items():
        d = tree
        for p in fp[:-1]:
            d = d.setdefault(p, {})
        d[fp[-1]] = jnp.asarray(TRANSFORMS[tf](sd[tk]).astype(np.float32))
    batch = _batch()
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_ref, g_ref = jax.jit(jax.value_and_grad(
        lambda p: jtrainer.scene_batch_loss(JViewFusion(jcfg), p, jb, key)))({"params": tree})
    draws = [_jax_draws(k, 3, model.cfg) for k in jax.random.split(key, 2)]
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    torch.save(dict(batch=tbatch, draws=draws), tmp / "in.pt")
    worker = str(REPO / "tests" / "torch_port_parallel_worker.py")
    run_ranks([[worker, str(tmp / "in.pt"), str(tmp / "out")]] * 2)
    run_ranks([[worker, str(tmp / "in.pt"), str(tmp / "one")]])
    one = torch.load(tmp / "one0.pt")
    return dict(ranks=[torch.load(tmp / f"out{r}.pt") for r in range(2)], loss_ref=loss_ref, g_ref=g_ref,
                table=table, loss=one["loss"], masters=one["masters"])


def test_two_ranks_loss_and_gradients_match_jax(dp_step):
    """(b) Each rank's loss (the mean over the ranks) and the gradient its
    optimizer read against jax.value_and_grad on both scenes: loss 1e-4,
    each reached leaf 1e-3 relative, the frozen towers and the leaves the
    loss does not reach zero on both sides."""
    s = dp_step
    top = max(np.abs(_leaf(s["g_ref"], fp)).max() for fp in s["table"])
    for res in s["ranks"]:
        close(res["loss"], s["loss_ref"], 1e-4)
        checked = 0
        for fp, (tk, tf) in s["table"].items():
            ref = _leaf(s["g_ref"], fp)
            if tk not in res["grads"]:  # frozen: VAE and CLIP
                assert tk.split(".")[0] in ("vae", "clip_image_encoder") and not ref.any(), tk
                continue
            got = TRANSFORMS[tf](res["grads"][tk].numpy())
            if np.abs(ref).max() <= 1e-6 * top:  # a gradient the structure makes zero, or one the loss does not reach
                assert np.abs(got).max() <= 1e-6 * top, tk
                continue
            close(got, ref, 1e-3)
            checked += 1
        assert checked > 200


def test_two_ranks_masters_equal_one_rank_on_both_scenes(dp_step):
    """(b) The masters after the step, on both ranks, bit-equal to one rank's
    step on both scenes with the same draws (the fp32 sum of the two
    scenes' gradients halves alike on both sides)."""
    s = dp_step
    close(s["loss"], s["loss_ref"], 1e-4)
    for res in s["ranks"]:
        assert torch.equal(res["loss"], s["loss"])
        assert res["masters"].keys() == s["masters"].keys()
        assert all(torch.equal(res["masters"][n], t) for n, t in s["masters"].items())


def test_reducing_at_the_optimizer_step_equals_reducing_every_call(dp_step):
    """(c) grad_accum_step 2: the accumulator averaged over the ranks at the
    optimizer step against the running mean of each call's gradient
    averaged over the ranks first; the same on both ranks."""
    a, b = dp_step["ranks"]
    for res in (a, b):
        top = max(float(t.abs().max()) for t in res["every_call"].values())
        assert top > 0 and res["at_update"].keys() == res["every_call"].keys()
        err = max(float((res["at_update"][n] - t).abs().max()) for n, t in res["every_call"].items())
        assert err <= 1e-6 * top, (err, top)
    assert all(torch.equal(a["at_update"][n], b["at_update"][n]) for n in a["at_update"])


# ------------------------------------------------------------ (d), (e)
def _write_gso(root: Path, scenes: int, size: int = 64) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    names = [f"scene_{s}" for s in range(scenes)]
    for name in names:
        (root / name).mkdir(parents=True)
        for i in range(16):
            rgba = (rng.uniform(size=(size, size, 4)) * 255).astype(np.uint8)
            rgba[..., 3] = 255
            Image.fromarray(rgba, "RGBA").save(root / name / f"{i:03d}.png")
    (root / "test.json").write_text(json.dumps(names))


@pytest.fixture(scope="module")
def gso(tmp_path_factory):
    root = tmp_path_factory.mktemp("gso")
    _write_gso(root, 3)
    return root


def _train_config(tmp, gso, exp):
    cfg = yaml.safe_load((REPO / "configs" / "train.yaml").read_text())
    cfg["dataset"] = {"target": "gso", "params": {"root": str(gso), "subset": "test", "image_size": 64}}
    cfg["trainer"].update(epochs=4, train_batch_size=3, grad_accum_step=2, scenes_per_chip=1)
    cfg["saver"] = dict(exp_dir=str(exp) + "/", print_interval=1, save_interval=1, loss_interval=1)
    p = tmp / f"{exp.name}.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def test_two_rank_train_cli_checkpoints_on_rank0_and_resumes(tmp_path, gso):
    """(d) 3 steps on two ranks by --dp 2 (two scenes a step, grad_accum_step
    2, three scenes: the epoch ends after step 2), then 2 steps and a
    resumed 1 on two ranks by --multihost: a checkpoint a step, written by
    rank 0 alone; both ranks resume from step 2; the step-3 checkpoints
    bit-equal."""
    train = ["-m", "mvdfusion_tpu_torch.cli.train", "--tiny", "--device", "cpu", "--seed", "3"]
    a, b = tmp_path / "a", tmp_path / "b"
    subprocess.run([sys.executable, *train, "-c", _train_config(tmp_path, gso, a), "--dp", "2", "--max-steps", "3"],
                   cwd=REPO, check=True, timeout=TIMEOUT, capture_output=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4", **STATIC_THREADS))
    cfg_b = _train_config(tmp_path, gso, b)
    outs = run_ranks([[*train, "-c", cfg_b, "--multihost", "--max-steps", "2"]] * 2)
    assert outs[0].count("saved checkpoint") == 2 and "saved checkpoint" not in outs[1], outs
    outs = run_ranks([[*train, "-c", cfg_b, "--multihost", "--max-steps", "1"]] * 2)
    for r, out in enumerate(outs):
        assert f"rank {r}: resumed from {b / 'ckpt' / 'step_00000002'}" in out, out
    assert outs[0].count("saved checkpoint") == 1 and "saved checkpoint" not in outs[1], outs
    for run in (a, b):
        assert sorted(os.listdir(run / "ckpt")) == ["latest"] + [f"step_{i:08d}" for i in (1, 2, 3)]
    ra, rb = restore_checkpoint(a / "ckpt" / "step_00000003"), restore_checkpoint(b / "ckpt" / "step_00000003")
    assert ra["step"] == rb["step"] == 3 and ra["epoch"] == rb["epoch"] == 1
    assert ra["opt_state"]["count"] == rb["opt_state"]["count"] == 1
    for part in ("params",):
        assert all(torch.equal(ra[part][n], rb[part][n]) for n in ra[part])
    for k in ("mu", "nu"):
        assert all(torch.equal(ra["opt_state"][k][n], rb["opt_state"][k][n]) for n in ra["opt_state"][k])


def test_two_rank_demo_writes_the_one_process_files(tmp_path, gso):
    """(e) Three scenes in batches of 2 (the second wraps to scene 0 and
    reports nothing for it), 3 targets, 1 step: two ranks under --multihost
    against one process at --scene-batch 1; the same files, the same
    metrics.json (scenes in scene order) and the same depth arrays."""
    text = (REPO / "configs" / "gso.yaml").read_text()
    runs = {}
    for name, argvs in (("one", None), ("two", 2)):
        exp = tmp_path / name
        cfg = text
        for x, y in (("root: demo_datasets/gso_eval/", f"root: {gso}/"), ("subset: test_syncdreamer", "subset: test"),
                     ("image_size: 256", "image_size: 64"), ("exp_dir: demo/", f"exp_dir: {exp}/"),
                     ("train_batch_size: 15", "train_batch_size: 3"),
                     ("ckpt_path: weights/mvdfusion_tpu.ckpt", f"ckpt_path: {tmp_path}/absent.ckpt")):
            assert x in cfg, x
            cfg = cfg.replace(x, y)
        (tmp_path / f"{name}.yaml").write_text(cfg)
        demo = ["-m", "mvdfusion_tpu_torch.cli.demo", "-c", str(tmp_path / f"{name}.yaml"), "--tiny", "--device",
                "cpu", "--steps", "1", "--eval-num", "3"]
        if argvs is None:
            subprocess.run([sys.executable, *demo], cwd=REPO, check=True, timeout=TIMEOUT, capture_output=True,
                           env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", **STATIC_THREADS))
        else:
            run_ranks([[*demo, "--multihost", "--scene-batch", "2"]] * argvs)
        vis = exp / "vis_gso_eval"
        runs[name] = (vis, sorted(os.listdir(vis)))
    (one, files), (two, files2) = runs["one"], runs["two"]
    assert files == files2 and len(files) == 3 * 5 + 1, files2
    m1, m2 = (json.loads((v / "metrics.json").read_text()) for v in (one, two))
    assert [m["scene"] for m in m2["scenes"]] == ["scene_0", "scene_1", "scene_2"]
    assert m1 == m2
    for f in files:
        if f.endswith(".npy"):
            assert np.array_equal(np.load(one / f), np.load(two / f)), f


# ------------------------------------------------------------ chip_smoke.py
def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke  # by name: parallel.spawn pickles its rank function by reference

    return chip_smoke


def test_chip_smoke_scenes_rehearsal_on_cpu():
    """chip_smoke.py's scenes phase at the tiny config on the CPU: two
    scenes in one pass against each alone, the same checks as on the card
    minus the launch counts."""
    assert _chip_smoke().run_scenes(2, "cpu", device="cpu", cfg=ViewFusionConfig().tiny())["counts"] == {}


def test_chip_smoke_dp_rehearsal_on_cpu():
    """chip_smoke.py's dp phase at the tiny config on the CPU: two ranks with
    one scene each over gloo, then rank 0 alone with both, the same checks
    as on the card (no NCCL rank: no card)."""
    res = _chip_smoke().run_dp("cpu", device="cpu", tiny=True)
    assert res["backend"] == "gloo" and res["world"] == 2 and res["ranks_agree"] and "nccl" not in res
