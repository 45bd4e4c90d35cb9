"""Procedural scene renderer, numpy only: the port's copy of the JAX
package's `train/render.py` (the functions the SLAM benchmark needs).

Scenes are textured quads in front of a backdrop, ray-cast per pixel in
camera coordinates, so a pixel ray is d = K^-1 (u, v, 1) with d_z = 1 and
the ray parameter is the z-depth. `render_trajectory` renders a smooth
orbit through one scene with exact intrinsics and world-to-camera poses:
the ground truth of `apps/eval_slam.py`. Same draws from the same
`numpy.random.Generator`, same arithmetic, so the same images as the JAX
package's renderer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _unit(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-12)


def make_scene(rng: np.random.Generator, textures: List[np.ndarray],
               n_quads: int = 12, depth_range: Tuple[float, float] = (3.0, 8.0)
               ) -> List[Dict[str, np.ndarray]]:
    """Random piecewise-planar scene in WORLD coordinates (world frame ==
    camera-0 frame; cameras are generated relative to it).

    Returns a list of quads, each {p0 (3,), e1 (3,), e2 (3,), tex (h,w,3)
    uint8}. Quad surface = p0 + a*e1 + b*e2, (a, b) in [0, 1]^2. The first
    quad is a large backdrop filling the frustum at the far plane so most
    rays hit geometry.
    """
    zmin, zmax = depth_range
    quads = []

    # backdrop: fronto-parallel at z ~ zmax, big enough for generous
    # camera motion (frustum half-width at zmax is ~0.7*zmax for a ~70
    # degree FoV; 3x margin covers the second camera's view too)
    half = 2.0 * zmax
    p0 = np.array([-half, -half, zmax * rng.uniform(0.95, 1.15)])
    quads.append({
        "p0": p0,
        "e1": np.array([2 * half, 0.0, rng.uniform(-0.5, 0.5)]),
        "e2": np.array([0.0, 2 * half, rng.uniform(-0.5, 0.5)]),
        "tex": textures[rng.integers(len(textures))],
    })

    # floating quads: centers inside the camera-0 frustum between zmin
    # and 0.9*zmax, random orientation biased towards camera-facing
    for _ in range(n_quads):
        z = rng.uniform(zmin, 0.9 * zmax)
        # stay within ~55% of the frustum so quads remain visible after
        # the second camera's rotation
        x = rng.uniform(-0.55, 0.55) * z
        y = rng.uniform(-0.55, 0.55) * z
        c = np.array([x, y, z])
        s1 = rng.uniform(0.4, 1.8) * z / 4
        s2 = rng.uniform(0.4, 1.8) * z / 4
        # orientation: start fronto-parallel, tilt by <= ~50 degrees
        ax = _unit(rng.normal(size=3))
        ang = rng.uniform(0, 0.9)
        Kx = np.array([[0, -ax[2], ax[1]],
                       [ax[2], 0, -ax[0]],
                       [-ax[1], ax[0], 0]])
        R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
        e1 = R @ np.array([s1, 0.0, 0.0])
        e2 = R @ np.array([0.0, s2, 0.0])
        quads.append({
            "p0": c - 0.5 * e1 - 0.5 * e2,
            "e1": e1, "e2": e2,
            "tex": textures[rng.integers(len(textures))],
        })
    return quads


def make_intrinsics(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    f = rng.uniform(0.75, 1.15) * w
    K = np.array([[f, 0, w / 2.0],
                  [0, f, h / 2.0],
                  [0, 0, 1.0]], np.float64)
    return K


def look_at_w2c(cam_pos: np.ndarray, target: np.ndarray,
                up: Optional[np.ndarray] = None) -> np.ndarray:
    """World-to-camera 4x4 for a camera at `cam_pos` looking at `target`
    (+z into the scene, +x right, +y down — the standard CV convention
    the MegaDepth poses use)."""
    fwd = _unit(target - cam_pos)
    upv = np.array([0.0, -1.0, 0.0]) if up is None else _unit(up)
    right = _unit(np.cross(upv, fwd))
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)   # rows = camera axes
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ cam_pos
    return T


def render_view(quads: List[Dict[str, np.ndarray]], K: np.ndarray,
                T_w2c: np.ndarray, h: int, w: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the quad scene. Returns (image (h, w, 3) uint8,
    depth (h, w) float32, zero where no geometry is hit)."""
    R, t = T_w2c[:3, :3], T_w2c[:3, 3]
    Kinv = np.linalg.inv(K)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32) + 0.5,
                       np.arange(h, dtype=np.float32) + 0.5)
    # camera-frame ray directions with d_z = 1 -> ray parameter == z-depth
    d = np.stack([u, v, np.ones_like(u)], axis=-1) @ Kinv.T.astype(np.float32)

    zbuf = np.full((h, w), np.inf, np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for q in quads:
        # quad into camera frame
        p0 = (R @ q["p0"] + t).astype(np.float32)
        e1 = (R @ q["e1"]).astype(np.float32)
        e2 = (R @ q["e2"]).astype(np.float32)
        n = np.cross(e1, e2).astype(np.float32)
        dn = d @ n                                   # (h, w)
        tt = np.where(np.abs(dn) > 1e-9, (p0 @ n) / np.where(
            np.abs(dn) > 1e-9, dn, 1.0), np.inf)     # ray parameter = z
        hit = (tt > 0.05) & (tt < zbuf)
        if not hit.any():
            continue
        # grazing rays carry tt=inf -> X mixes +-inf -> a/b go NaN; those
        # pixels are already excluded by `hit`, but NaN survives np.clip
        # and casts to INT32_MIN, crashing the texture fancy-index. Zero
        # the parameter on non-hit pixels instead.
        tt_safe = np.where(hit, tt, 0.0)
        X = d * tt_safe[..., None] - p0              # (h, w, 3) in-plane
        # local coordinates via the quad's dual basis
        g11, g12, g22 = e1 @ e1, e1 @ e2, e2 @ e2
        det = g11 * g22 - g12 * g12
        x1, x2 = X @ e1, X @ e2
        a = (g22 * x1 - g12 * x2) / det
        b = (g11 * x2 - g12 * x1) / det
        hit &= (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        if not hit.any():
            continue
        tex = q["tex"]
        th, tw = tex.shape[:2]
        # bilinear texture sample at (a, b)
        fx = np.clip(a * (tw - 1), 0, tw - 1 - 1e-4)
        fy = np.clip(b * (th - 1), 0, th - 1 - 1e-4)
        x0i, y0i = fx.astype(np.int32), fy.astype(np.int32)
        wx, wy = (fx - x0i)[..., None], (fy - y0i)[..., None]
        texf = tex.astype(np.float32)
        c = (texf[y0i, x0i] * (1 - wx) * (1 - wy) +
             texf[y0i, x0i + 1] * wx * (1 - wy) +
             texf[y0i + 1, x0i] * (1 - wx) * wy +
             texf[y0i + 1, x0i + 1] * wx * wy)
        img = np.where(hit[..., None], c, img)
        zbuf = np.where(hit, tt, zbuf)

    depth = np.where(np.isfinite(zbuf), zbuf, 0.0).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), depth


def render_trajectory(rng: np.random.Generator,
                      textures: List[np.ndarray],
                      n_frames: int, w: int, h: int,
                      n_quads: int = 16,
                      arc_deg: float = 35.0,
                      bob_frac: float = 0.04,
                      loop: bool = True) -> Dict[str, np.ndarray]:
    """Render a smooth camera TRAJECTORY through one random scene — the
    ground-truth sequence for the SLAM/ATE benchmark.

    The camera orbits the scene center about the vertical axis with
    angle arc_deg * sin(phase) plus a small vertical bob; with
    `loop=True` the phase runs a full cycle so the path revisits its
    start (exercising loop closure), otherwise a quarter cycle (pure
    odometry drift). Returns images (N,h,w,3) uint8, poses (N,4,4)
    world-to-camera, K (3,3).
    """
    quads = make_scene(rng, textures, n_quads=n_quads)
    centers = [q["p0"] + 0.5 * q["e1"] + 0.5 * q["e2"] for q in quads[1:]]
    center = np.mean(centers, axis=0)
    K = make_intrinsics(rng, w, h)
    d = np.linalg.norm(center)

    phase = np.linspace(0.0, 2 * np.pi if loop else 0.5 * np.pi, n_frames)
    images, poses = [], []
    for ph in phase:
        th = np.deg2rad(arc_deg) * np.sin(ph)
        c, s = np.cos(th), np.sin(th)
        Ry = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        cam = center + Ry @ (-center)            # th=0 -> origin
        cam = cam + np.array([0.0, bob_frac * d * np.sin(2 * ph), 0.0])
        T = look_at_w2c(cam, center)
        img, _ = render_view(quads, K, T, h, w)
        images.append(img)
        poses.append(T)
    return {"images": np.stack(images), "poses": np.stack(poses),
            "K": K}
