"""The port's training data against the JAX package on the CPU:
data/synthetic.py::SyntheticScenes and data/datasets.py::Objaverse, the
config registry's Objaverse targets, and the train CLI on
configs/train.yaml's own `objaverse` target.

SyntheticScenes: both families, textured on and off, at 16 and 32 px on two
seeds; images, stored depths, masks, cameras and angles within 1e-5 of the
JAX module's, except at silhouette pixels, where the two packages' fp32
rays (JAX's and torch's arithmetic) may put a ray on either side of an
edge: SILHOUETTE_ALLOWANCE pixels a scene may flip between hit and miss
(so far none has). The closed-form intersections and the cross-view
consistency property are tests/test_synthetic_data.py's, here on the port's
own class, cameras and grid_sample.

Objaverse: a synthesized tree (64 renders a scene: jpg RGB, 16-bit depth
png, jpg mask) through both loaders with depth and mask; bit-equal on the
PIL route (both native loaders switched off), and on the native route (the
C++ loader on both sides, the masks through PIL) at the stored size and
within 1e-6 resized, with GSO's RGBA pngs under the white composite too.
The route rules: where the native library cannot be built, the port reads
through PIL (equal to the JAX package's PIL route) and says why once on
stderr; a file the built decoder refuses raises with its path.
"""

import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mvdfusion_tpu.data.datasets as jdatasets
import mvdfusion_tpu.native as jnative
import mvdfusion_tpu_torch.data.datasets as tdatasets
from mvdfusion_tpu.core import config as jconfig
from mvdfusion_tpu.data.synthetic import SyntheticScenes as JScenes
from mvdfusion_tpu_torch.core import config as tconfig
from mvdfusion_tpu_torch import native
from mvdfusion_tpu_torch.data.datasets import GSO, Objaverse
from mvdfusion_tpu_torch.data.synthetic import DEPTH_SCALE, DEPTH_SHIFT, SyntheticScenes, metric_to_stored

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
SILHOUETTE_ALLOWANCE = 4  # pixels a scene (over its 16 views) whose hit/miss may flip


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


# -------------------------------------------------------------- synthetic
@pytest.mark.parametrize("family,textured", [("spheres", False), ("spheres", True), ("mixed", False),
                                             ("mixed", True)])
@pytest.mark.parametrize("size,seed", [(16, 0), (32, 3)])
def test_synthetic_scenes_match_jax(family, textured, size, seed):
    ours = SyntheticScenes(n_scenes=2, image_size=size, seed=seed, textured=textured, family=family)
    ref = JScenes(n_scenes=2, image_size=size, seed=seed, textured=textured, family=family)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        assert a["index"] == b["index"] and a["idx"] == b["idx"]
        flip = a["masks"][..., 0] != b["masks"][..., 0]  # (16, H, W)
        assert flip.sum() <= SILHOUETTE_ALLOWANCE, f"{flip.sum()} pixels flip between hit and miss"
        keep = ~flip
        for k in ("images", "depths", "masks"):
            assert a[k].shape == b[k].shape and a[k].dtype == np.float32, k
            diff = np.abs(a[k] - b[k]).max(axis=-1)[keep]
            assert diff.max() <= TOL, (k, diff.max())
        for k in ("R", "T", "f", "c", "azimuth", "elevation"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL, err_msg=k)


def test_box_cylinder_intersections_exact():
    """The port's closed-form intersections against hand-computable rays."""
    o = np.zeros((1, 1, 1, 3), np.float32)
    o[..., 2] = -2.0  # origin behind, looking +z
    d = np.zeros((1, 1, 1, 3), np.float32)
    d[..., 2] = 1.0
    # box at the origin, half-extents 0.5: entry at z = -0.5 -> t = 1.5
    t, n, valid = SyntheticScenes._intersect_box(o, d, np.zeros(3, np.float32), np.full(3, 0.5, np.float32))
    assert valid.all() and np.isclose(t[0, 0, 0], 1.5)
    np.testing.assert_allclose(n[0, 0, 0], [0, 0, -1], atol=1e-6)
    # cylinder r = 0.25, hh = 0.4 on the y axis: side entry at z = -0.25 -> t = 1.75
    t, n, valid = SyntheticScenes._intersect_cylinder(o, d, np.zeros(3, np.float32), 0.25, 0.4)
    assert valid.all() and np.isclose(t[0, 0, 0], 1.75)
    np.testing.assert_allclose(n[0, 0, 0], [0, 0, -1], atol=1e-6)
    # cap hit: straight down through the top cap
    o2 = np.zeros((1, 1, 1, 3), np.float32)
    o2[..., 1] = 2.0
    d2 = np.zeros((1, 1, 1, 3), np.float32)
    d2[..., 1] = -1.0
    t, n, valid = SyntheticScenes._intersect_cylinder(o2, d2, np.zeros(3, np.float32), 0.25, 0.4)
    assert valid.all() and np.isclose(t[0, 0, 0], 1.6)
    np.testing.assert_allclose(n[0, 0, 0], [0, 1, 0], atol=1e-6)
    # sphere r = 0.5 at the origin: entry at z = -0.5 -> t = 1.5, normal -z
    t, n, valid = SyntheticScenes._intersect_sphere(o, d, np.zeros(3, np.float32), 0.5)
    assert valid.all() and np.isclose(t[0, 0, 0], 1.5)
    np.testing.assert_allclose(n[0, 0, 0], [0, 0, -1], atol=1e-6)
    # grazing miss beside the box
    o3 = o.copy()
    o3[..., 0] = 0.75
    _, _, valid = SyntheticScenes._intersect_box(o3, d, np.zeros(3, np.float32), np.full(3, 0.5, np.float32))
    assert not valid.any()


@pytest.mark.parametrize("textured,family", [(False, "spheres"), (True, "spheres"), (True, "mixed")])
def test_cross_view_consistency(textured, family):
    """Unproject view A's rendered depth with the port's rays, reproject
    into view B with its cameras and grid_sample view B (negated xy): where
    the point is unoccluded in B, the sampled color matches A's."""
    from mvdfusion_tpu_torch.geometry.cameras import camera_slice, make_cameras, transform_points_ndc
    from mvdfusion_tpu_torch.geometry.gridsample import grid_sample
    from mvdfusion_tpu_torch.geometry.rays import pixel_rays, rays_to_points

    H = 48
    s = SyntheticScenes(n_scenes=1, image_size=H, seed=1, textured=textured, family=family)[0]
    cams = make_cameras(s["R"], s["T"], s["f"], s["c"])
    va, vb = 2, 4
    rays_a = pixel_rays(camera_slice(cams, [va]), H, H)
    z_a = s["depths"][va, ..., 0] * DEPTH_SCALE + DEPTH_SHIFT  # metric
    pts = rays_to_points(rays_a, torch.as_tensor(z_a)[None, ..., None]).reshape(1, -1, 3)
    ndc = transform_points_ndc(camera_slice(cams, [vb]), pts)  # x, y, 1/view-z
    samp_rgb = grid_sample(torch.as_tensor(s["images"][vb][None]), -ndc[..., :2]).numpy().reshape(H, H, 3)
    samp_depth = grid_sample(torch.as_tensor(s["depths"][vb][None]), -ndc[..., :2]).numpy().reshape(H, H)
    zb = 1.0 / ndc[0, :, 2].numpy().reshape(H, H)

    vis = (s["masks"][va, ..., 0] > 0.5) & (np.abs(metric_to_stored(zb) - samp_depth) < 0.015)
    vis &= (np.abs(ndc[0, :, :2].numpy().reshape(H, H, 2)) < 0.95).all(axis=-1)
    assert vis.sum() > 50, f"too few mutually visible pixels: {vis.sum()}"
    err = np.abs(samp_rgb - s["images"][va])[vis]
    assert np.median(err) < 0.02, np.median(err)
    assert err.mean() < 0.06, err.mean()


# -------------------------------------------------------------- Objaverse
@pytest.fixture(scope="module")
def objaverse_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("objaverse")
    CS.write_objaverse(root, 2, 32, seed=0, subset="tiny")
    return root


def _equal_scenes(a, b, atol=0.0):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == np.float32 and a[k].shape == np.asarray(b[k]).shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("size,fix,depth,mask", [(32, True, True, True), (24, True, True, False),
                                                 (48, False, False, True)])
def test_objaverse_matches_jax(objaverse_tree, monkeypatch, size, fix, depth, mask):
    """The port's loader against the JAX loader on the PIL route (both
    native decoders switched off) at the stored size and resized down and
    up, with and without fix_elevation, depth and mask: bit-equal."""
    monkeypatch.setattr(jdatasets, "_native_batch", lambda *a, **k: None)
    monkeypatch.setattr(tdatasets, "_native_batch", lambda *a, **k: None)
    kw = dict(subset="tiny", stage="train", image_size=size, fix_elevation=fix, load_depth=depth, load_mask=mask)
    ours, ref = Objaverse(str(objaverse_tree), **kw), jdatasets.Objaverse(str(objaverse_tree), **kw)
    assert len(ours) == len(ref) == 2
    a = ours[1]
    assert a["images"].shape == (16 if fix else 64, size, size, 3)
    if fix:
        np.testing.assert_allclose(a["elevation"], np.deg2rad(30.0), atol=1e-6)
    if depth:
        assert a["depths"].shape[-1] == 1 and a["depths"].max() > 1.0  # 16-bit depth / 255
    _equal_scenes(a, ref[1])


def test_objaverse_matches_jax_native_decoder(objaverse_tree):
    """Against the JAX loader as it runs here (its C++ decoder where built)
    at the stored size, the port on its own route (its copy of that
    decoder): bit-equal."""
    kw = dict(subset="tiny", image_size=32, load_depth=True, load_mask=True)
    _equal_scenes(Objaverse(str(objaverse_tree), **kw)[0], jdatasets.Objaverse(str(objaverse_tree), **kw)[0])


@pytest.fixture(scope="module")
def gso_tree(tmp_path_factory):
    """Two GSO scenes of 16 random RGBA pngs at 32^2, alpha random (about
    half the pixels composite to white)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("gso")
    rng = np.random.default_rng(4)
    for s in range(2):
        (root / f"scene_{s}").mkdir()
        for i in range(16):
            rgba = (rng.uniform(size=(32, 32, 4)) * 255).astype(np.uint8)
            Image.fromarray(rgba, "RGBA").save(root / f"scene_{s}" / f"{i:03d}.png")
    (root / "test.json").write_text('["scene_0", "scene_1"]')
    return root


@pytest.mark.parametrize("size", [24, 48])
def test_native_route_matches_jax_resized(objaverse_tree, gso_tree, size):
    """Objaverse (fix_elevation, depth and mask) and GSO (the white
    composite) read off their stored 32^2 through both packages as each runs
    here, the native loader on both: within 1e-6 (the same loader.cc)."""
    if not (jnative.available() and native.available()):
        pytest.skip(f"a native loader is not built on this box: {native.reason()}")
    kw = dict(subset="tiny", stage="train", image_size=size, fix_elevation=True, load_depth=True, load_mask=True)
    a = Objaverse(str(objaverse_tree), **kw)[1]
    assert a["images"].shape == (16, size, size, 3) and a["depths"].max() > 1.0
    _equal_scenes(a, jdatasets.Objaverse(str(objaverse_tree), **kw)[1], atol=1e-6)
    a = GSO(str(gso_tree), subset="test", image_size=size)[0]
    assert a["images"].shape == (16, size, size, 3) and (a["images"] == 1.0).all(axis=-1).mean() > 0.2
    _equal_scenes(a, jdatasets.GSO(str(gso_tree), subset="test", image_size=size)[0], atol=1e-6)


def test_failed_build_takes_pil(objaverse_tree, gso_tree, monkeypatch, capsys):
    """With the native build made to fail, the port's Objaverse and GSO read
    through PIL, equal to the JAX package's PIL route, and the reason is
    printed on stderr once."""
    monkeypatch.setattr(native, "LIB_PATH", objaverse_tree / "absent" / "libmvdf_loader.so")
    monkeypatch.setattr(native, "CXX", str(objaverse_tree / "no-such-g++"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_why", None)
    monkeypatch.setattr(tdatasets, "_told", False)
    monkeypatch.setattr(jdatasets, "_native_batch", lambda *a, **k: None)
    kw = dict(subset="tiny", stage="train", image_size=24, fix_elevation=True, load_depth=True, load_mask=True)
    _equal_scenes(Objaverse(str(objaverse_tree), **kw)[0], jdatasets.Objaverse(str(objaverse_tree), **kw)[0])
    _equal_scenes(GSO(str(gso_tree), subset="test", image_size=48)[1],
                  jdatasets.GSO(str(gso_tree), subset="test", image_size=48)[1])
    err = capsys.readouterr().err
    assert err.count("the native image loader is unavailable") == 1 and "no-such-g++" in err, err


def test_refused_file_raises_with_its_path(tmp_path):
    """With the library built, a truncated jpg in an Objaverse scene raises
    native.DecodeError naming it (no quiet fall back to PIL)."""
    if not native.available():
        pytest.skip(f"the native loader is not built on this box: {native.reason()}")
    CS.write_objaverse(tmp_path, 1, 16, seed=5, subset="tiny", views=range(40, 56))
    bad = tmp_path / "tiny" / "uid_0000" / "views" / "047_rgb.jpg"
    bad.write_bytes(bad.read_bytes()[:40])
    with pytest.raises(native.DecodeError, match=str(bad)):
        Objaverse(str(tmp_path), subset="tiny", image_size=16)[0]


def _train_yaml(tmp_path, root, size, exp=None):
    import yaml

    cfg = yaml.safe_load((REPO / "configs" / "train.yaml").read_text())
    cfg["dataset"]["params"].update(root=str(root), image_size=size)
    if exp is not None:
        cfg["saver"] = dict(exp_dir=str(exp) + "/", print_interval=1, save_interval=2, vis_interval=0,
                            loss_interval=10**9)
    p = tmp_path / "train.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return p


def test_build_dataset_on_train_yaml(tmp_path, objaverse_tree, monkeypatch):
    """configs/train.yaml's `objaverse` target, its root moved to the tree:
    the port's Objaverse under every name the registry knows, scenes equal
    to the JAX package's build_dataset on the same file."""
    import yaml

    monkeypatch.setattr(jdatasets, "_native_batch", lambda *a, **k: None)
    monkeypatch.setattr(tdatasets, "_native_batch", lambda *a, **k: None)
    raw = yaml.safe_load((REPO / "configs" / "train.yaml").read_text())
    assert raw["dataset"]["target"] == "objaverse"
    subset = raw["dataset"]["params"]["subset"]
    root = tmp_path / "obj"
    CS.write_objaverse(root, 1, 24, seed=1, subset=subset, views=range(40, 56))
    cfg = tconfig.load_yaml(str(_train_yaml(tmp_path, root, 24)))
    ds = tconfig.build_dataset(cfg)
    assert isinstance(ds, Objaverse) and ds.subset == subset and len(ds) == 1
    _equal_scenes(ds[0], jconfig.build_dataset(jconfig.load_yaml(str(tmp_path / "train.yaml")))[0])
    for target in ("dataset.objaverse.Objaverse", "mvdfusion_tpu.data.datasets.Objaverse",
                   "mvdfusion_tpu_torch.data.datasets.Objaverse", "objaverse"):
        assert tconfig._dataset_registry()[target] is Objaverse, target


def test_train_cli_on_objaverse(tmp_path):
    """python -m mvdfusion_tpu_torch.cli.train on configs/train.yaml (its
    root, image size and saver moved under tmp) --tiny --device cpu
    --max-steps 2: the `objaverse` target loads 48^2 renders resized to 64^2,
    two steps of 4 scenes print finite losses and write a checkpoint."""
    root = tmp_path / "obj"
    import yaml

    subset = yaml.safe_load((REPO / "configs" / "train.yaml").read_text())["dataset"]["params"]["subset"]
    CS.write_objaverse(root, 2, 48, seed=2, subset=subset, views=range(40, 56))
    exp = tmp_path / "exp"
    cfg = _train_yaml(tmp_path, root, 64, exp=exp)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "mvdfusion_tpu_torch.cli.train", "-c", str(cfg), "--tiny",
                          "--device", "cpu", "--max-steps", "2"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"step \d+ loss (\S+)", out.stdout)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), out.stdout
    assert (exp / "ckpt" / "latest").read_text() == "step_00000002"
    assert (exp / "ckpt" / "step_00000002").exists()


def test_chip_smoke_loader_rehearsal_on_cpu():
    """chip_smoke.py's loader phase at 64^2 renders read at 32^2: the probe
    finds the headers here, the build, both routes timed, native against PIL
    at the stored size within the phase's tolerances."""
    if CS.loader_probe():
        pytest.skip("the host lacks the loader's headers")
    res = CS.run_loader("cpu", stored=64, size=32)
    assert res["native_s"] > 0 and res["pil_s"] > 0 and res["build_s"] > 0
