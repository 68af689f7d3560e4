"""The golden cases of tests/test_geometry.py on the port's geometry
(mvdfusion_tpu_torch/geometry/): the look_at simple case, the flipped-sign
NDC pixel grid, the world orientation anchor (world +x on the image's right,
+y on its top, and the side flip as the camera orbits past +x), and the
analytic reprojection through the GridAttn chain (cameras -> pixel_rays ->
rays_to_points -> transform_points_ndc -> negated-xy grid_sample) with every
single-sign mutation of the gather convention failing. Same cases and
thresholds as the JAX package's tests; no JAX on either side. The synthetic
dataset's stored-depth convention rests on these. Last, concat_cameras and
normalize_cameras against the JAX package's, within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvdfusion_tpu.geometry import cameras as jcameras
from mvdfusion_tpu_torch.geometry.cameras import (
    camera_slice,
    concat_cameras,
    look_at_view_transform,
    make_cameras,
    normalize_cameras,
    transform_points_ndc,
)
from mvdfusion_tpu_torch.geometry.gridsample import bilinear_gather, grid_sample
from mvdfusion_tpu_torch.geometry.rays import ndc_pixel_grid, pixel_rays, rays_to_points


def test_look_at_simple_case():
    # camera at (0, 0, 1.5) looking at the origin, y-up
    R, T = look_at_view_transform(dist=1.5, elev=0.0, azim=0.0)
    C = -(T @ R[0].T)  # row-vector center
    np.testing.assert_allclose(C[0], [0, 0, 1.5], atol=1e-6)
    # the world origin is 1.5 in front of the camera (+z view)
    np.testing.assert_allclose(T[0], [0, 0, 1.5], atol=1e-6)
    np.testing.assert_allclose(R[0] @ R[0].T, np.eye(3), atol=1e-6)


def test_pixel_grid_matches_reference_convention():
    g = ndc_pixel_grid(4, 4)
    half = 1.0 / 4
    # top-left (row 0, col 0) is the (+x, +y) extreme (flipped-sign grid)
    np.testing.assert_allclose(g[0, 0], [1 - half, 1 - half], atol=1e-6)
    np.testing.assert_allclose(g[-1, -1], [-1 + half, -1 + half], atol=1e-6)
    # and the port's rays carry the same grid
    R, T = look_at_view_transform(dist=1.5, elev=0.0, azim=0.0)
    rays = pixel_rays(make_cameras(R, T, (2.1875, 2.1875)), 4, 4)
    np.testing.assert_array_equal(rays.xys.numpy(), g)


def _render_spheres(cams, H, W, centers, radii, colors):
    """Analytic Lambertian spheres through the port's pixel_rays: exact RGB
    and exact view-space depth (the ray parameter is view-space depth: the
    directions are z-normalised)."""
    rays = pixel_rays(cams, H, W)
    o = rays.origins.numpy().astype(np.float64)
    d = rays.directions.numpy().astype(np.float64)
    V = o.shape[0]
    t_best = np.full((V, H, W), np.inf)
    hit = np.full((V, H, W), -1, np.int32)
    a = np.sum(d * d, axis=-1)
    for k in range(len(radii)):
        oc = o - centers[k]
        b = 2.0 * np.sum(d * oc, axis=-1)
        cc = np.sum(oc * oc, axis=-1) - radii[k] ** 2
        disc = b * b - 4.0 * a * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / (2.0 * a)
        ok = (disc > 0.0) & (t > 1e-3) & (t < t_best)
        t_best = np.where(ok, t, t_best)
        hit = np.where(ok, k, hit)
    mask = hit >= 0
    depth = np.where(mask, t_best, 10.0)
    light = np.asarray([0.5, 1.0, 0.3])
    light = light / np.linalg.norm(light)
    pts = o + d * depth[..., None]
    img = np.ones((V, H, W, 3))
    for k in range(len(radii)):
        sel = hit == k
        if not sel.any():
            continue
        n = (pts[sel] - centers[k]) / radii[k]
        lam = np.maximum(n @ light, 0.0)
        img[sel] = colors[k] * (0.35 + 0.65 * lam[:, None])
    return img.astype(np.float32), depth.astype(np.float32), mask


def test_world_orientation_anchor():
    """A camera at azim=0 / elev=0 sits at (0, 0, d) looking along -z with
    +y up, so its right hand is world +x; the grid's column 0 carries x_ndc =
    +1-1/W, so world +x lands at large column indices and world +y at small
    row indices; as the camera orbits past +x the sphere flips sides."""
    R, T = look_at_view_transform(dist=2.0, elev=0.0, azim=0.0)
    cams = make_cameras(R, T, (2.1875, 2.1875))
    H, W = 40, 56
    one = np.asarray([[0.9, 0.1, 0.1]])
    for center, axis in [((0.4, 0.0, 0.0), "col"), ((0.0, 0.4, 0.0), "row")]:
        _, _, mask = _render_spheres(cams, H, W, np.asarray([center]), np.asarray([0.15]), one)
        assert mask[0].any(), "anchor sphere out of frame"
        ys, xs = np.nonzero(mask[0])
        if axis == "col":
            assert xs.mean() > W / 2 + 2, "world +x must appear on the image RIGHT"
        else:
            assert ys.mean() < H / 2 - 2, "world +y must appear on the image TOP"
    R, T = look_at_view_transform(dist=2.0, elev=0.0, azim=120.0)
    cams2 = make_cameras(R, T, (2.1875, 2.1875))
    _, _, mask2 = _render_spheres(cams2, H, W, np.asarray([(0.4, 0.0, 0.0)]), np.asarray([0.15]), one)
    ys2, xs2 = np.nonzero(mask2[0])
    assert xs2.mean() < W / 2 - 2, "after the camera orbits past +x the sphere must flip sides"


def test_analytic_reprojection_photometric():
    """Warp view A into view B through the GridAttn chain at ground-truth
    depth and demand photometric reconstruction (grid_sample and the fp32
    4-tap gather), then demand that every single-sign mutation of the gather
    convention fails. Non-square images pin the H/W-independent [-1, 1]
    grid convention."""
    centers = np.asarray([[0.15, 0.05, -0.1], [-0.2, 0.1, 0.15], [0.0, -0.18, 0.05]])
    radii = np.asarray([0.22, 0.18, 0.20])
    colors = np.asarray([[0.9, 0.15, 0.15], [0.15, 0.6, 0.9], [0.95, 0.75, 0.1]])
    H, W = 48, 64
    pairs = [(0.0, 30.0, 30.0, 30.0), (90.0, 30.0, 150.0, -10.0), (200.0, 45.0, 240.0, 20.0)]
    for azA, elA, azB, elB in pairs:
        R, T = look_at_view_transform(dist=1.8, elev=[elA, elB], azim=[azA, azB])
        cams = make_cameras(R, T, (2.1875, 2.1875))
        img, depth, mask = _render_spheres(cams, H, W, centers, radii, colors)
        camA, camB = camera_slice(cams, [0]), camera_slice(cams, [1])

        raysA = pixel_rays(camA, H, W)
        pts = rays_to_points(raysA, torch.as_tensor(depth[:1, :, :, None]))  # (1, H, W, 1, 3)
        ndcB = transform_points_ndc(camB, pts.reshape(1, H * W, 3))  # (1, N, 3)
        zB = 1.0 / ndcB[0, :, 2].numpy()
        ndc_np = ndcB.numpy()

        imgB = torch.as_tensor(img[1:2])
        depB = torch.as_tensor(depth[1:2, :, :, None])
        xy = ndcB[..., :2]

        # visibility: in B's frame, and B's rendered depth there agrees with
        # the point's analytic view-space z (occlusion and silhouette rejection)
        dB = grid_sample(depB, -xy)[0, :, 0].numpy()
        inb = (np.abs(ndc_np[0, :, 0]) < 1.0 - 2.0 / W) & (np.abs(ndc_np[0, :, 1]) < 1.0 - 2.0 / H)
        visible = mask[0].reshape(-1) & inb & (np.abs(dB - zB) < 0.02) & (zB > 0)
        frac = visible.sum() / max(mask[0].sum(), 1)
        assert frac > 0.15, f"co-visible fraction degenerate ({frac:.2f}): the projection is off"

        tgt = img[0].reshape(-1, 3)[visible]
        for sampler in (grid_sample, bilinear_gather):
            got = sampler(imgB, -xy)[0].numpy()[visible]
            err = np.abs(got - tgt).mean()
            assert err < 0.03, f"correct warp reconstruction error {err:.4f}"

        muts = {
            "no_negation": xy,
            "flip_x_only": torch.stack([xy[..., 0], -xy[..., 1]], dim=-1),
            "flip_y_only": torch.stack([-xy[..., 0], xy[..., 1]], dim=-1),
            "swapped_xy": torch.stack([-xy[..., 1], -xy[..., 0]], dim=-1),
        }
        for name, mxy in muts.items():
            got = grid_sample(imgB, mxy)[0].numpy()[visible]
            err_m = np.abs(got - tgt).mean()
            assert err_m > 0.12, f"mutation {name} not detected (err {err_m:.4f}) at pair {azA},{azB}"


# ------------------------------------------------- camera helpers against JAX
def _random_cameras(rng, b):
    """b cameras: random rotations (QR of a normal matrix, det +1), T, f, c."""
    q = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0]
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return [q.astype(np.float32), rng.normal(size=(b, 3)).astype(np.float32) * 2,
            rng.uniform(1, 3, size=(b, 2)).astype(np.float32), rng.normal(size=(b, 2)).astype(np.float32) * 0.1]


def _close_cameras(ours, ref, atol):
    for a, b, name in zip(ours, ref, ("R", "T", "focal_length", "principal_point")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name)


def test_concat_cameras_matches_jax():
    rng = np.random.default_rng(0)
    parts = [_random_cameras(rng, b) for b in (3, 1, 2)]
    ours = concat_cameras([make_cameras(*p) for p in parts])
    ref = jcameras.concat_cameras([jcameras.make_cameras(*p) for p in parts])
    assert len(ours) == len(ref) == 6
    _close_cameras(ours, ref, 0.0)


@pytest.mark.parametrize("distance", [3.5, 1.25])
def test_normalize_cameras_matches_jax(distance):
    """T rescaled so the mean centre distance is `distance` (3.5 by
    default): within 1e-6 of the JAX function at 4 cameras, R, f and c
    untouched. The JAX function takes exactly 4 (its `_replace` meets the
    NamedTuple's __len__, which counts cameras); at 3 and 5 the port is held
    to the same formula in float64."""
    kw = {} if distance == 3.5 else dict(distance=distance)
    p = _random_cameras(np.random.default_rng(1), 4)
    ours = normalize_cameras(make_cameras(*p), **kw)
    ref = jcameras.normalize_cameras(jcameras.make_cameras(*p), **kw)
    _close_cameras(ours, ref, 1e-6)
    assert torch.equal(ours.R, torch.as_tensor(p[0])) and float(jnp.abs(ref.T).max()) > 0.1
    for b in (3, 5):
        R, T, f, c = _random_cameras(np.random.default_rng(b), b)
        ours = normalize_cameras(make_cameras(R, T, f, c), **kw)
        centres = -np.einsum("bj,bkj->bk", T.astype(np.float64), R.astype(np.float64))
        want = T * (distance / np.linalg.norm(centres, axis=1).mean())
        np.testing.assert_allclose(ours.T.numpy(), want, rtol=0, atol=1e-6)
        assert len(ours) == b and torch.equal(ours.focal_length, torch.as_tensor(f))
