"""Ray generation and NDC warp (run once per dataset load).

Counterpart of `nerf_siren_tpu/datasets/ray_utils.py` with the same
numerics:
- pixel -> camera directions without the +0.5 pixel-centre offset,
  dir = [(i - W/2)/f, -(j - H/2)/f, -1] (OpenGL-style, -z forward),
- world rays: rotate by c2w[:, :3], L2-normalise, broadcast the origin,
- NDC warp: shift origins to the near plane, then the projective transform
  for unbounded forward-facing scenes.
As in the JAX package, the first two go through the C++ host library
(`nerf_siren_tpu_torch/native`, built with g++ at first use) unless the
environment sets `NERF_SIREN_TPU_NATIVE=0`; numpy is the reference and the
fallback where no compiler exists.
"""
from __future__ import annotations

import os

import numpy as np

_USE_NATIVE = os.environ.get("NERF_SIREN_TPU_NATIVE", "1") != "0"


def _native():
    if not _USE_NATIVE:
        return None
    from nerf_siren_tpu_torch import native
    return native if native.available() else None


def get_ray_directions(H: int, W: int, focal: float) -> np.ndarray:
    """Per-pixel ray directions in camera coordinates. Returns (H, W, 3) f32."""
    nat = _native()
    if nat is not None:
        return nat.ray_directions(H, W, focal)
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    return np.stack(
        [(i - W / 2) / focal, -(j - H / 2) / focal, -np.ones_like(i)], axis=-1
    )


def get_rays(directions: np.ndarray, c2w: np.ndarray):
    """World-space rays of one camera: (H, W, 3) directions and a (3, 4)
    camera-to-world matrix -> rays_o, rays_d (H*W, 3) f32, rays_d unit."""
    nat = _native()
    if nat is not None:
        return nat.world_rays(np.asarray(directions, np.float32),
                              np.asarray(c2w, np.float32))
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape)
    return rays_o.reshape(-1, 3).astype(np.float32), rays_d.reshape(-1, 3).astype(np.float32)


def get_ndc_rays(H: int, W: int, focal: float, near, rays_o: np.ndarray, rays_d: np.ndarray):
    """Warp world rays into NDC (forward-facing scenes; near plane at z=-near).

    Returns rays_o, rays_d (N, 3) such that marching t in [0, 1] spans
    near -> inf."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2

    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


def make_ray_batch(rays_o: np.ndarray, rays_d: np.ndarray, near, far) -> np.ndarray:
    """Pack rays into the (N, 8) layout the renderer consumes."""
    n = rays_o.shape[0]
    near_a = (np.full((n, 1), near, np.float32) if np.isscalar(near)
              else np.asarray(near, np.float32).reshape(n, 1))
    far_a = (np.full((n, 1), far, np.float32) if np.isscalar(far)
             else np.asarray(far, np.float32).reshape(n, 1))
    return np.concatenate([rays_o, rays_d, near_a, far_a], axis=1).astype(np.float32)
