"""Analytic synthetic multi-view RGB-D scenes, the learning proof's dataset
(counterpart of mvdfusion_tpu/data/synthetic.py).

Colored Lambertian spheres (family "spheres"), or spheres, axis-aligned
boxes and capped y-axis cylinders with a guaranteed contact pair (family
"mixed"), rendered analytically, exact RGB and exact view-space depth, on
the 16-view rig (data/rigs.py). The rays come from the port's own geometry
(geometry/cameras.py, geometry/rays.py::pixel_rays) in fp32 on the CPU, so
the depth is in the convention GridAttn unprojects: the stored [0, 1] depth
maps to metric z = stored * 2 + 0.5. Scene parameters are seeded with numpy
(seed * 10_007 + index), so a scene is the same in both packages; the
intersections are closed forms in numpy.

Returned dicts follow the dataset contract (data/datasets.py):
{index, idx, images (S,H,W,3) [0,1], R, T, f, c, azimuth, elevation,
 depths (S,H,W,1), masks (S,H,W,1)}.
"""

from __future__ import annotations

import numpy as np

from mvdfusion_tpu_torch.data.rigs import AZIMUTHS_16, ELEVATIONS_16, fixed_rig

# saturated, mutually distant base colors
_PALETTE = np.asarray(
    [
        [0.90, 0.15, 0.15],
        [0.15, 0.60, 0.90],
        [0.20, 0.80, 0.25],
        [0.95, 0.75, 0.10],
        [0.70, 0.20, 0.85],
        [0.95, 0.45, 0.10],
        [0.10, 0.80, 0.75],
        [0.90, 0.30, 0.60],
    ],
    np.float32,
)

_LIGHT = np.asarray([0.5, 1.0, 0.3], np.float32)
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)

# stored-depth convention: metric z = stored * 2.0 + 0.5 (GridAttn)
DEPTH_SCALE = 2.0
DEPTH_SHIFT = 0.5
BACKGROUND_STORED_DEPTH = 1.0  # metric 2.5, just past the far side of the rig


def metric_to_stored(z: np.ndarray) -> np.ndarray:
    return (z - DEPTH_SHIFT) / DEPTH_SCALE


class SyntheticScenes:
    """n_scenes procedurally-seeded analytic scenes, 16 fixed views each.

    family="spheres" (default): colored Lambertian spheres.
    family="mixed": spheres + axis-aligned boxes + capped y-axis cylinders
    (all closed-form ray intersections with exact normals/depth), with the
    first two primitives placed in guaranteed contact so every scene has
    occlusion-contact edges: flat faces, straight silhouettes and hard
    depth discontinuities the sphere family lacks.
    """

    n_views = 16

    def __init__(
        self,
        n_scenes: int = 4,
        image_size: int = 64,
        seed: int = 0,
        n_spheres: int = 3,
        textured: bool = False,
        family: str = "spheres",
    ):
        assert family in ("spheres", "mixed"), family
        self.n_scenes = n_scenes
        self.image_size = image_size
        self.seed = seed
        self.n_spheres = n_spheres
        self.family = family
        # textured=True modulates each sphere's albedo by a smooth analytic
        # lat/long sinusoid (view-consistent: a function of the surface
        # point only). Gives every pose a distinctive appearance — constant-
        # albedo spheres are nearly pose-ambiguous away from silhouettes, so
        # the learning proof's novel-view metric saturates early on shading
        # alone.
        self.textured = textured
        self.R, self.T, self.f, self.c = fixed_rig(AZIMUTHS_16, ELEVATIONS_16)
        self._rays = self._compute_rays()

    def _compute_rays(self):
        """Per-pixel world rays from the port's geometry (cameras ->
        pixel_rays) in fp32 on the CPU, as numpy; computed once, the fixed
        rig is shared by all scenes."""
        import torch

        from mvdfusion_tpu_torch.geometry.cameras import make_cameras
        from mvdfusion_tpu_torch.geometry.rays import pixel_rays

        with torch.no_grad():
            cams = make_cameras(self.R, self.T, self.f, self.c, device="cpu")
            rays = pixel_rays(cams, self.image_size, self.image_size)
        return rays.origins.numpy(), rays.directions.numpy()

    def __len__(self) -> int:
        return self.n_scenes

    def scene_params(self, index: int):
        """Sphere centers (K,3), radii (K,), colors (K,3) for scene
        `index` — deterministic in (seed, index)."""
        rng = np.random.default_rng(self.seed * 10_007 + index)
        k = self.n_spheres
        # centers in a ball of radius 0.35 (rig half-FOV covers ~0.68 at
        # the origin plane, so centers+radii stay fully in frame)
        u = rng.normal(size=(k, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        centers = u * rng.uniform(0.08, 0.35, size=(k, 1))
        radii = rng.uniform(0.12, 0.26, size=(k,))
        colors = _PALETTE[rng.choice(len(_PALETTE), size=k, replace=False)]
        # per-sphere texture params: band frequencies (low, to stay well
        # below the 64^2 Nyquist at sphere scale) and a phase
        tex = np.stack(
            [
                rng.integers(2, 5, size=k),  # azimuthal bands
                rng.integers(1, 4, size=k),  # polar bands
            ],
            axis=1,
        ).astype(np.float32)
        phase = rng.uniform(0.0, 2 * np.pi, size=(k,)).astype(np.float32)
        return centers.astype(np.float32), radii.astype(np.float32), colors, tex, phase

    # ---- mixed family: spheres + boxes + capped cylinders ----------------

    def scene_params_mixed(self, index: int):
        """Primitive types (K,), centers (K,3), sizes (K,3), colors (K,3),
        texture freqs/phases for scene `index`; types: 0 sphere (sizes[:,0]
        = radius), 1 axis-aligned box (sizes = half-extents), 2 y-axis
        capped cylinder (sizes[:,0] = radius, sizes[:,1] = half-height).
        Primitives 0 and 1 are placed in contact (bounding spheres
        overlapping ~15%) so every scene has an occlusion-contact edge."""
        rng = np.random.default_rng(self.seed * 10_007 + 7919 * (index + 1))
        k = self.n_spheres
        types = rng.integers(0, 3, size=k)
        if (types == 0).all():  # guarantee at least one flat-faced primitive
            types[int(rng.integers(0, k))] = 1 + int(rng.integers(0, 2))
        u = rng.normal(size=(k, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        centers = (u * rng.uniform(0.05, 0.30, size=(k, 1))).astype(np.float32)
        sizes = rng.uniform(0.10, 0.22, size=(k, 3)).astype(np.float32)
        colors = _PALETTE[rng.choice(len(_PALETTE), size=k, replace=False)]
        tex = rng.integers(2, 5, size=(k, 2)).astype(np.float32)
        phase = rng.uniform(0.0, 2 * np.pi, size=(k,)).astype(np.float32)

        def bound(i):  # bounding-sphere radius per primitive
            if types[i] == 0:
                return sizes[i, 0]
            if types[i] == 1:
                return float(np.linalg.norm(sizes[i]))
            return float(np.hypot(sizes[i, 0], sizes[i, 1]))

        if k >= 2:  # contact pair
            dirn = rng.normal(size=3)
            dirn /= np.linalg.norm(dirn)
            centers[1] = centers[0] + (0.85 * (bound(0) + bound(1)) * dirn).astype(
                np.float32
            )
        # keep everything in frame (rig half-FOV ~0.68 at the origin plane)
        lim = 0.45
        centers = np.clip(centers, -lim, lim)
        return types, centers, sizes, colors, tex, phase

    @staticmethod
    def _intersect_sphere(o, d, c, r):
        oc = o - c
        a = np.sum(d * d, axis=-1)
        b = 2.0 * np.sum(d * oc, axis=-1)
        cc = np.sum(oc * oc, axis=-1) - r * r
        disc = b * b - 4.0 * a * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = (-b - sq) / (2.0 * a)
        valid = (disc > 0.0) & (t > 1e-3)
        pts = o + d * t[..., None]
        n = (pts - c) / r
        return t, n, valid

    @staticmethod
    def _intersect_box(o, d, c, h):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t1 = (c - h - o) * inv
            t2 = (c + h - o) * inv
        tlo = np.nan_to_num(np.minimum(t1, t2), nan=-np.inf)
        thi = np.nan_to_num(np.maximum(t1, t2), nan=np.inf)
        tmin = tlo.max(axis=-1)
        tmax = thi.min(axis=-1)
        valid = (tmax > tmin) & (tmin > 1e-3)
        axis = np.argmax(tlo, axis=-1)  # face attaining the entry t
        n = -np.sign(np.take_along_axis(d, axis[..., None], axis=-1)) * np.eye(
            3, dtype=np.float32
        )[axis]
        return tmin, n.astype(np.float32), valid

    @staticmethod
    def _intersect_cylinder(o, d, c, r, hh):
        o2 = o - c
        a = d[..., 0] ** 2 + d[..., 2] ** 2
        b = 2.0 * (o2[..., 0] * d[..., 0] + o2[..., 2] * d[..., 2])
        cc = o2[..., 0] ** 2 + o2[..., 2] ** 2 - r * r
        disc = b * b - 4.0 * a * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            t_side = (-b - sq) / (2.0 * a)
            t_top = (hh - o2[..., 1]) / d[..., 1]
            t_bot = (-hh - o2[..., 1]) / d[..., 1]
        y_side = o2[..., 1] + t_side * d[..., 1]
        ok_side = (disc > 0.0) & (t_side > 1e-3) & (np.abs(y_side) <= hh)
        ok_side &= np.isfinite(t_side)

        def cap_ok(t):
            with np.errstate(invalid="ignore"):
                x = o2[..., 0] + t * d[..., 0]
                z = o2[..., 2] + t * d[..., 2]
                inside = x * x + z * z <= r * r
            return np.isfinite(t) & (t > 1e-3) & inside

        ok_top, ok_bot = cap_ok(t_top), cap_ok(t_bot)
        big = np.float32(np.inf)
        ts = np.stack(
            [
                np.where(ok_side, t_side, big),
                np.where(ok_top, t_top, big),
                np.where(ok_bot, t_bot, big),
            ]
        )
        which = np.argmin(ts, axis=0)
        t = np.take_along_axis(ts, which[None], axis=0)[0]
        valid = np.isfinite(t)
        t_safe = np.where(valid, t, 1.0)
        pts = o2 + d * t_safe[..., None]
        n_side = np.stack(
            [pts[..., 0] / r, np.zeros_like(t), pts[..., 2] / r], axis=-1
        )
        n_cap = np.zeros_like(n_side)
        n_cap[..., 1] = np.where(which == 1, 1.0, -1.0)
        n = np.where((which == 0)[..., None], n_side, n_cap)
        return t, n.astype(np.float32), valid

    def _render_mixed(self, index: int):
        types, centers, sizes, colors, tex, phase = self.scene_params_mixed(index)
        o, d = self._rays
        V, H, W, _ = o.shape
        t_best = np.full((V, H, W), np.inf, np.float32)
        hit_idx = np.full((V, H, W), -1, np.int32)
        n_best = np.zeros((V, H, W, 3), np.float32)
        for k in range(len(types)):
            if types[k] == 0:
                t, n, valid = self._intersect_sphere(o, d, centers[k], sizes[k, 0])
            elif types[k] == 1:
                t, n, valid = self._intersect_box(o, d, centers[k], sizes[k])
            else:
                t, n, valid = self._intersect_cylinder(
                    o, d, centers[k], sizes[k, 0], sizes[k, 1]
                )
            closer = valid & (t < t_best)
            t_best = np.where(closer, t, t_best)
            hit_idx = np.where(closer, k, hit_idx)
            n_best = np.where(closer[..., None], n, n_best)

        mask = hit_idx >= 0
        t_safe = np.where(
            mask, t_best, DEPTH_SHIFT + DEPTH_SCALE * BACKGROUND_STORED_DEPTH
        )
        pts = o + d * t_safe[..., None]
        img = np.ones((V, H, W, 3), np.float32)
        for k in range(len(types)):
            sel = hit_idx == k
            if not sel.any():
                continue
            n = n_best[sel]
            albedo = colors[k]
            if self.textured:
                # smooth world-space bands over the surface point: a pure
                # function of the surface point, so all views agree exactly.
                # Frequencies ~tex*10 rad/unit keep the wavelength >= ~6 px
                # at 64^2 over the ~1.4-unit frame (below Nyquist).
                p = pts[sel] - centers[k]
                m = 0.5 + 0.5 * np.sin(tex[k, 0] * 10.0 * p[:, 0] + phase[k]) * np.cos(
                    tex[k, 1] * 10.0 * p[:, 1]
                )
                albedo = colors[k] * (0.45 + 0.55 * m[:, None])
            lam = np.maximum(n @ _LIGHT, 0.0)
            img[sel] = albedo * (0.35 + 0.65 * lam[:, None])
        img = np.clip(img, 0.0, 1.0)
        stored = np.clip(metric_to_stored(t_safe), 0.0, 1.0).astype(np.float32)
        return img, stored[..., None], mask[..., None].astype(np.float32)

    def render(self, index: int):
        """Analytic render of scene `index` for all 16 views.

        Returns (images (V,H,W,3), stored_depth (V,H,W,1), mask (V,H,W,1)).
        Ray param t IS the view-space depth (geometry/rays.py: directions
        are z-depth-normalised), so primitive intersection yields metric
        depth directly.
        """
        if self.family == "mixed":
            return self._render_mixed(index)
        centers, radii, colors, tex, phase = self.scene_params(index)
        o, d = self._rays  # (V, H, W, 3) each
        V, H, W, _ = o.shape

        t_best = np.full((V, H, W), np.inf, np.float32)
        hit_idx = np.full((V, H, W), -1, np.int32)
        a = np.sum(d * d, axis=-1)  # (V, H, W)
        for k in range(len(radii)):
            oc = o - centers[k]
            b = 2.0 * np.sum(d * oc, axis=-1)
            cc = np.sum(oc * oc, axis=-1) - radii[k] ** 2
            disc = b * b - 4.0 * a * cc
            valid = disc > 0.0
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-b - sq) / (2.0 * a)
            valid &= t > 1e-3
            closer = valid & (t < t_best)
            t_best = np.where(closer, t, t_best)
            hit_idx = np.where(closer, k, hit_idx)

        mask = hit_idx >= 0
        t_safe = np.where(mask, t_best, DEPTH_SHIFT + DEPTH_SCALE * BACKGROUND_STORED_DEPTH)

        # Lambertian shading, view-independent (so cross-view colors agree)
        pts = o + d * t_safe[..., None]
        img = np.ones((V, H, W, 3), np.float32)  # white background
        for k in range(len(radii)):
            sel = hit_idx == k
            if not sel.any():
                continue
            n = (pts[sel] - centers[k]) / radii[k]
            albedo = colors[k]
            if self.textured:
                # smooth lat/long bands over the unit normal: a pure
                # function of the surface point, so all views agree exactly
                phi = np.arctan2(n[:, 2], n[:, 0])
                theta = np.arccos(np.clip(n[:, 1], -1.0, 1.0))
                m = 0.5 + 0.5 * np.sin(tex[k, 0] * phi + phase[k]) * np.cos(
                    tex[k, 1] * theta
                )
                albedo = colors[k] * (0.45 + 0.55 * m[:, None])
            lam = np.maximum(n @ _LIGHT, 0.0)
            img[sel] = albedo * (0.35 + 0.65 * lam[:, None])

        stored = np.clip(metric_to_stored(t_safe), 0.0, 1.0).astype(np.float32)
        return img, stored[..., None], mask[..., None].astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        images, depths, masks = self.render(index)
        return {
            "index": index,
            "idx": f"synthetic_{self.seed}_{index}",
            "images": images,
            "R": self.R,
            "T": self.T,
            "f": self.f,
            "c": self.c,
            "azimuth": AZIMUTHS_16.astype(np.float32),
            "elevation": ELEVATIONS_16.astype(np.float32),
            "depths": depths,
            "masks": masks,
        }
