"""Synthetic partial-overlap rigid-registration pairs (host numpy).

Counterpart of ``sgaligner_tpu/reg/synthetic_pairs.py``, a copy of its
functions (the port imports nothing of the JAX package): scenes are unions
of random planar / cylinder / corner patches (``make_scene``) or planar
indoor rooms with clutter (``make_scene_room``), optionally degraded toward
real reconstructions (``roughen_scene``); two overlapping crops are taken
and the source crop is moved by a random rigid transform (``make_pair``, or
``make_pair_from_cloud`` over a given cloud). The same generator consumed in
the same order gives the same arrays as the original.
"""

from __future__ import annotations

import numpy as np


def random_rigid(rng: np.random.Generator, max_angle_deg: float = 360.0,
                 max_trans: float = 1.0) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.deg2rad(rng.uniform(0.0, max_angle_deg))
    kx, ky, kz = axis
    km = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    r = np.eye(3) + np.sin(ang) * km + (1 - np.cos(ang)) * (km @ km)
    t = np.eye(4)
    t[:3, :3] = r
    t[:3, 3] = rng.uniform(-max_trans, max_trans, size=3)
    return t


def make_scene(rng: np.random.Generator, n_points: int = 4096,
               n_patches: int = 8, extent: float = 2.0) -> np.ndarray:
    """Union of random oriented rectangles, cylinder walls and box corners —
    varied local geometry (planes alone make patches locally
    indistinguishable, starving the matcher of discriminative features)."""
    pts = []
    per = n_points // n_patches
    for _ in range(n_patches):
        kind = rng.integers(3)
        origin = rng.uniform(-extent, extent, size=3)
        u, v = rng.normal(size=3), rng.normal(size=3)
        u /= np.linalg.norm(u)
        v -= u * (v @ u)
        v /= np.linalg.norm(v)
        n = np.cross(u, v)
        if kind == 0:      # rectangle
            a = rng.uniform(0.4, 1.5, size=2)
            coords = rng.uniform(0, 1, size=(per, 2)) * a
            thick = rng.normal(size=(per, 1)) * 0.01
            pts.append(origin + coords[:, :1] * u + coords[:, 1:] * v
                       + thick * n)
        elif kind == 1:    # cylinder wall segment
            radius = rng.uniform(0.15, 0.6)
            height = rng.uniform(0.3, 1.2)
            arc = rng.uniform(np.pi / 2, 2 * np.pi)
            th = rng.uniform(0, arc, size=per)
            h = rng.uniform(0, height, size=per)
            pts.append(origin + radius * np.cos(th)[:, None] * u
                       + radius * np.sin(th)[:, None] * v + h[:, None] * n)
        else:              # two faces meeting at an edge (corner)
            a = rng.uniform(0.3, 0.9, size=2)
            half = per // 2
            c1 = rng.uniform(0, 1, size=(half, 2)) * a
            c2 = rng.uniform(0, 1, size=(per - half, 2)) * a
            pts.append(origin + c1[:, :1] * u + c1[:, 1:] * v)
            pts.append(origin + c2[:, :1] * u + c2[:, 1:] * n)
    pts = np.concatenate(pts)[:n_points]
    return pts.astype(np.float32)


def make_scene_room(rng: np.random.Generator, n_points: int = 4096
                    ) -> np.ndarray:
    """Indoor-room scene: floor + partial walls + furniture-like clutter.

    The patch-union generator (``make_scene``) is feature-rich everywhere;
    REAL scans (e.g. upstream's example_data) are dominated by large
    self-similar planar surfaces where superpoint patches are locally
    indistinguishable — the measured failure mode of the matcher on real
    geometry. This family reproduces that hardness for training."""
    w, d = rng.uniform(3.0, 6.0, size=2)
    h = rng.uniform(2.2, 3.0)
    surfaces = []  # (area_weight, sampler(count) -> [c, 3])

    def rect(origin, eu, ev, a, b):
        origin, eu, ev = map(np.asarray, (origin, eu, ev))

        def sample(c):
            uv = rng.uniform(0, 1, size=(c, 2))
            return origin + uv[:, :1] * eu * a + uv[:, 1:] * ev * b
        return sample

    surfaces.append((w * d, rect([0, 0, 0], [1, 0, 0], [0, 1, 0], w, d)))
    for origin, eu, span in (([0, 0, 0], [1, 0, 0], w),
                             ([0, d, 0], [1, 0, 0], w),
                             ([0, 0, 0], [0, 1, 0], d),
                             ([w, 0, 0], [0, 1, 0], d)):
        if rng.random() < 0.85:
            cover = rng.uniform(0.5, 1.0)
            start = rng.uniform(0, 1 - cover)
            o = np.asarray(origin, float) + np.asarray(eu, float) * start * span
            surfaces.append((cover * span * h,
                             rect(o, eu, [0, 0, 1], cover * span, h)))
    wall_area = sum(a for a, _ in surfaces)

    clutter = []
    for _ in range(rng.integers(6, 14)):
        cx, cy = rng.uniform(0.3, 1.0) * w * 0.9, rng.uniform(0.3, 1.0) * d * 0.9
        kind = rng.integers(3)
        yaw = rng.uniform(0, 2 * np.pi)
        eu = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        ev = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        if kind == 0:          # box: top + 4 sides
            a, b = rng.uniform(0.3, 1.2, size=2)
            hh = rng.uniform(0.3, 1.1)
            o = np.array([cx, cy, 0.0]) - (eu * a + ev * b) / 2
            clutter.append((a * b, rect(o + [0, 0, hh], eu, ev, a, b)))
            for oo, u, s in ((o, eu, a), (o + ev * b, eu, a),
                             (o, ev, b), (o + eu * a, ev, b)):
                clutter.append((s * hh, rect(oo, u, [0, 0, 1], s, hh)))
        elif kind == 1:        # vertical cylinder shell
            radius = rng.uniform(0.1, 0.4)
            hh = rng.uniform(0.4, 1.2)

            def cyl(c, cx=cx, cy=cy, radius=radius, hh=hh):
                th = rng.uniform(0, 2 * np.pi, size=c)
                z = rng.uniform(0, hh, size=c)
                return np.stack([cx + radius * np.cos(th),
                                 cy + radius * np.sin(th), z], axis=1)
            clutter.append((2 * np.pi * radius * hh, cyl))
        else:                  # elevated slab (table/shelf top)
            a, b = rng.uniform(0.4, 1.4, size=2)
            z0 = rng.uniform(0.4, 1.4)
            o = np.array([cx, cy, z0]) - (eu * a + ev * b) / 2
            clutter.append((a * b, rect(o, eu, ev, a, b)))
    clutter_area = sum(a for a, _ in clutter) or 1.0

    # density bias: clutter gets ~half the points despite much smaller area
    # (real scans oversample furniture relative to bare walls)
    pts = []
    n_walls = int(n_points * 0.55)
    n_clutter = n_points - n_walls
    for group, total, budget in ((surfaces, wall_area, n_walls),
                                 (clutter, clutter_area, n_clutter)):
        for area, sampler in group:
            # ceil so the trimmed union never undershoots n_points
            c = max(int(np.ceil(budget * area / total)), 4)
            pts.append(sampler(c))
    pts = np.concatenate(pts)
    pts = pts[rng.permutation(len(pts))[:n_points]]
    pts = pts - pts.mean(axis=0)
    return pts.astype(np.float32)


def roughen_scene(rng: np.random.Generator, pts: np.ndarray,
                  bump_amp: float = 0.025, bump_waves: int = 6,
                  hole_frac: float = 0.12, density_strength: float = 0.5
                  ) -> np.ndarray:
    """Degrade an ideal synthetic scene toward real-reconstruction statistics.

    Measured on upstream's example scans (data.npy): real clouds are
    bumpy (only 2-5% of 48-NN neighborhoods are strictly planar vs ~100% on
    ideal synthetic walls), have occlusion holes, and sample density varies
    smoothly across the scene. Three matched degradations:

    * multi-scale surface displacement — a sum of ``bump_waves`` random
      low-frequency 3-D sinusoids, ~``bump_amp`` m amplitude (cm-scale
      reconstruction bumps, NOT white noise: neighborhoods stay coherent);
    * occlusion holes — points inside random balls removed until about
      ``hole_frac`` of the cloud is gone;
    * smooth density variation — probabilistic keep by a low-frequency field
      (``density_strength`` = peak-to-trough keep-probability swing).
    """
    pts = np.asarray(pts, np.float32)
    # smooth displacement field: sum of random plane waves per axis
    disp = np.zeros_like(pts)
    for _ in range(bump_waves):
        k = rng.normal(size=3)
        k *= rng.uniform(1.5, 6.0) / np.linalg.norm(k)   # wavelength ~1-4 m
        phase = rng.uniform(0, 2 * np.pi)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        disp += np.sin(pts @ k + phase)[:, None] * axis
    disp *= bump_amp / max(bump_waves ** 0.5, 1.0)
    pts = pts + disp.astype(np.float32)

    keep = np.ones(len(pts), bool)
    # occlusion holes
    target = int(len(pts) * hole_frac)
    removed = 0
    for _ in range(24):
        if removed >= target:
            break
        c = pts[rng.integers(len(pts))]
        r = rng.uniform(0.15, 0.45)
        inside = keep & (np.sum((pts - c) ** 2, axis=1) < r * r)
        removed += int(inside.sum())
        keep[inside] = False
    # smooth density variation
    k = rng.normal(size=3)
    k *= rng.uniform(1.0, 3.0) / np.linalg.norm(k)
    field = 0.5 * (1 + np.sin(pts @ k + rng.uniform(0, 2 * np.pi)))  # [0, 1]
    p_keep = 1.0 - density_strength * field
    keep &= rng.random(len(pts)) < p_keep
    if keep.sum() < 512:      # degenerate degradation: keep the bumpy cloud
        return pts
    return pts[keep]


def make_pair(rng: np.random.Generator, n_points: int = 4096,
              overlap: float = 0.6, noise: float = 0.005,
              max_angle_deg: float = 360.0, max_trans: float = 1.0,
              return_scene: bool = False, kind: str = "patches"):
    """Returns (src [n,3], ref [m,3], gt_transform src->ref frame)
    (+ the raw scene cloud in the ref frame when ``return_scene`` —
    the "raw scan" role in the modified-chamfer metric).

    Crops two overlapping half-spaces of a scene; the SOURCE crop is expressed
    in its own (randomly transformed) frame; gt maps src coords to ref coords.

    ``kind``: "patches" (default, the original feature-rich generator),
    "room" (planar indoor scenes, ``make_scene_room``), or "mix" (50/50 per
    pair). A "+rough" suffix (e.g. "mix+rough") additionally degrades the
    scene toward real-reconstruction statistics via ``roughen_scene``
    (surface bumps, occlusion holes, density variation) BEFORE cropping, so
    both views and the metric scene see the degraded cloud. The default
    leaves the rng stream and therefore every existing held-out eval
    unchanged.
    """
    n_scene = int(n_points / max(overlap, 0.3)) + 256
    kind_arg = kind                   # degenerate-crop retries re-roll fresh
    rough = kind.endswith("+rough")
    if rough:
        kind = kind[: -len("+rough")]
    if kind == "mix":
        kind = "room" if rng.random() < 0.5 else "patches"
    if kind == "room":
        scene = make_scene_room(rng, n_points=n_scene)
    else:
        scene = make_scene(rng, n_points=n_scene)
    if rough:
        scene = roughen_scene(rng, scene)
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    proj = scene @ d
    lo, hi = np.quantile(proj, [0.0, 1.0])
    span = hi - lo
    # two end-anchored windows of length w overlap by 2w - span;
    # 2w - span = overlap * span  =>  w = span * (1 + overlap) / 2
    w = span * (1.0 + overlap) / 2.0
    ref_sel = proj <= lo + w
    src_sel = proj >= hi - w
    ref = scene[ref_sel]
    src_world = scene[src_sel]
    if len(ref) < 64 or len(src_world) < 64:  # degenerate crop: retry
        return make_pair(rng, n_points, overlap, noise, max_angle_deg,
                         max_trans, return_scene, kind_arg)
    gt_inv = random_rigid(rng, max_angle_deg, max_trans)  # world -> src frame
    src = src_world @ gt_inv[:3, :3].T + gt_inv[:3, 3]
    src = src + rng.normal(size=src.shape).astype(np.float32) * noise
    ref = ref + rng.normal(size=ref.shape).astype(np.float32) * noise
    gt = np.linalg.inv(gt_inv)  # src frame -> world == ref frame
    out = (src.astype(np.float32), ref.astype(np.float32),
           gt.astype(np.float32))
    if return_scene:
        return out + (scene.astype(np.float32),)
    return out


def make_pair_from_cloud(rng: np.random.Generator, cloud: np.ndarray,
                         overlap: float = 0.5, noise: float = 0.005,
                         max_angle_deg: float = 360.0, max_trans: float = 1.0,
                         keep: float = 0.7, return_scene: bool = False,
                         _retries: int = 16):
    """``make_pair`` crop/transform protocol over a PROVIDED cloud (e.g. a
    real scan): two overlapping half-space crops along a random direction,
    INDEPENDENTLY subsampled (``keep``) so the views share no exact vertices,
    sensor noise, and a random rigid on the source view. Returns
    (src, ref, gt[, scene]) exactly like ``make_pair``."""
    cloud = np.asarray(cloud, np.float32)
    for _ in range(_retries):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        proj = cloud @ d
        lo, hi = proj.min(), proj.max()
        w = (hi - lo) * (1.0 + overlap) / 2.0
        ref = cloud[proj <= lo + w]
        src_world = cloud[proj >= hi - w]
        ref = ref[rng.random(len(ref)) < keep]
        src_world = src_world[rng.random(len(src_world)) < keep]
        if len(ref) >= 256 and len(src_world) >= 256:
            break
    else:
        raise ValueError("cloud too small/degenerate for the requested crops")
    gt_inv = random_rigid(rng, max_angle_deg, max_trans)
    src = src_world @ gt_inv[:3, :3].T + gt_inv[:3, 3]
    src = src + rng.normal(size=src.shape).astype(np.float32) * noise
    ref = ref + rng.normal(size=ref.shape).astype(np.float32) * noise
    gt = np.linalg.inv(gt_inv).astype(np.float32)
    out = (src.astype(np.float32), ref.astype(np.float32), gt)
    if return_scene:
        return out + (cloud,)
    return out
