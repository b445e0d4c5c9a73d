"""Traffic generation: cameras, rays and target colours from a seed.

One general generator for every cell; a cell's traffic file only gives
its parameters. Cameras sit on a sphere of `radius` around the origin and
look at it (OpenGL convention, -z forward), at azimuths and elevations
drawn from the seed (numpy `SeedSequence`), as the Blender scenes' cameras
do. Rays are (N, 8) float32 [origin, unit direction, near, far] made on
the device; pixel centres are not offset, as the Blender loader's
`get_ray_directions` has them.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *salt]))


def torch_generator(seed: int, device, *salt: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *salt)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, *salt]).generate_state(1, np.uint64)[0]))
    return g


def orbit_poses(cams: dict, seed: int) -> np.ndarray:
    """(count, 3, 4) camera-to-world matrices [R | eye]: azimuths uniform in
    [0, 2 pi), elevations uniform in `elevation_deg` [lo, hi], both drawn
    from the seed, on the sphere of `radius`."""
    r = rng(seed, 1)
    n = cams["count"]
    theta = r.uniform(0.0, 2 * math.pi, n)
    lo, hi = cams["elevation_deg"]
    phi = np.radians(r.uniform(lo, hi, n))
    poses = np.empty((n, 3, 4))
    for k in range(n):
        eye = cams["radius"] * np.array([math.cos(phi[k]) * math.cos(theta[k]),
                                         math.cos(phi[k]) * math.sin(theta[k]), math.sin(phi[k])])
        z = eye / np.linalg.norm(eye)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        poses[k] = np.concatenate([np.stack([x, np.cross(z, x), z], 1), eye[:, None]], 1)
    return poses


def camera_rays(pose: np.ndarray, cams: dict, device) -> torch.Tensor:
    """(height * width, 8) rays of one camera, made on `device`."""
    h, w = cams["height"], cams["width"]
    focal = 0.5 * w / math.tan(0.5 * cams["camera_angle_x"])
    c2w = torch.tensor(pose[:, :3], dtype=torch.float32, device=device)
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - w / 2) / focal, -(j - h / 2) / focal, -torch.ones_like(i)], -1)
    dirs = dirs.reshape(-1, 3) @ c2w.T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    n = dirs.shape[0]
    eye = torch.tensor(pose[:, 3], dtype=torch.float32, device=device).expand(n, 3)
    return torch.cat([eye, dirs, torch.full((n, 1), float(cams["near"]), device=device),
                      torch.full((n, 1), float(cams["far"]), device=device)], -1)


def target_colours(rays: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """(N, 3) colours in [0, 1] of the point at depth `mid` of each ray:
    0.5 + 0.5 sin(p @ A + b), with `mix` = [A (3, 3); b (1, 3); mid]."""
    p = rays[:, 0:3] + rays[:, 3:6] * mix[4, 0]
    return 0.5 + 0.5 * torch.sin(p @ mix[0:3] + mix[3])


def colour_mix(seed: int, device) -> torch.Tensor:
    g = torch_generator(seed, device, 2)
    mix = torch.empty(5, 3, device=device)
    mix[0:3] = torch.randn(3, 3, generator=g, device=device) * 1.5
    mix[3] = torch.rand(3, generator=g, device=device) * 2 * math.pi
    mix[4] = 4.0
    return mix


def ray_table(cams: dict, seed: int, device):
    """The rays of every camera of `cams` and their target colours: (rays,
    rgbs), numpy arrays on the host as a training set's loader holds them,
    made on `device` a batch of cameras at a time."""
    poses = orbit_poses(cams, seed)
    mix = colour_mix(seed, device)
    n_pix = cams["height"] * cams["width"]
    n = len(poses) * n_pix
    rays_out, rgbs_out = np.empty((n, 8), np.float32), np.empty((n, 3), np.float32)
    per = max(1, (1 << 24) // n_pix)   # cameras a batch: at most ~16 M rays on the device
    for k in range(0, len(poses), per):
        rays = torch.cat([camera_rays(p, cams, device) for p in poses[k:k + per]])
        lo = k * n_pix
        rays_out[lo:lo + rays.shape[0]] = rays.cpu().numpy()
        rgbs_out[lo:lo + rays.shape[0]] = target_colours(rays, mix).cpu().numpy()
    return rays_out, rgbs_out


def frame_rays(cams: dict, seed: int, device) -> torch.Tensor:
    """(count, height * width, 8) rays of the cameras of `cams`, on `device`."""
    return torch.stack([camera_rays(p, cams, device) for p in orbit_poses(cams, seed)])
