"""The analytic 3-sphere scene: ground truth by ray tracing, cameras on a
sphere looking at the origin.

The port's copy of `SPHERES`, `LIGHT`, `trace_gt`, `look_at` and
`make_rays` of the JAX package's `tools/fast_frontier.py` (numpy, the same
code): three spheres at staggered depths (so they occlude each other),
Lambert-shaded under one light, a white background, inside the near 2 /
far 6 band of cameras at radius 4.
"""
from __future__ import annotations

import numpy as np

SPHERES = [  # center, radius, color — staggered depths force occlusion
    (np.array([0.0, 0.0, 0.0]), 0.9, np.array([0.9, 0.25, 0.2])),
    (np.array([0.8, 0.55, 0.35]), 0.45, np.array([0.2, 0.7, 0.3])),
    (np.array([-0.7, -0.5, -0.4]), 0.55, np.array([0.25, 0.35, 0.9])),
]
LIGHT = np.array([0.5, -0.3, 0.8]) / np.linalg.norm([0.5, -0.3, 0.8])


def trace_gt(rays_o: np.ndarray, rays_d: np.ndarray,
             spheres=SPHERES) -> np.ndarray:
    """Analytic render: nearest sphere hit, Lambert-shaded, white back."""
    n = rays_o.shape[0]
    best_t = np.full(n, np.inf, np.float32)
    rgb = np.ones((n, 3), np.float32)
    d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    for c, r, col in spheres:
        oc = rays_o - c
        b = np.sum(oc * d, -1)
        disc = b * b - (np.sum(oc * oc, -1) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        ok = hit & (t > 0) & (t < best_t)
        normal = (rays_o[ok] + t[ok, None] * d[ok] - c) / r
        shade = 0.65 + 0.35 * np.clip(normal @ LIGHT, 0, 1)
        rgb[ok] = col * shade[:, None]
        best_t[ok] = t[ok]
    return rgb


def look_at(eye):
    """The (3, 3) camera-to-world rotation of a camera at `eye` looking at
    the origin, z up (OpenGL: the camera looks down its -z)."""
    eye = np.asarray(eye, np.float32)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd], 1)


def make_rays(c2w_rot, eye, h, w, focal):
    """(h w, 8) rays [origin, direction (not normalised), near 2, far 6] of
    an h x w pinhole camera."""
    i, j = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(i - w / 2) / focal, -(j - h / 2) / focal,
                     -np.ones_like(i)], -1).astype(np.float32)
    d = dirs.reshape(-1, 3) @ c2w_rot.T
    o = np.broadcast_to(eye.astype(np.float32), d.shape).copy()
    near = np.full((d.shape[0], 1), 2.0, np.float32)
    far = np.full((d.shape[0], 1), 6.0, np.float32)
    return np.concatenate([o, d.astype(np.float32), near, far], -1)
