"""EG3D triplane volume renderer.

Counterpart of `nerf_siren_tpu/render/triplane.py` (reference:
volumetric_rendering/renderer.py, ray_marcher.py, math_utils.py;
eg3d_training/triplane.py, eg3d_renderer.py):
- geometry: `get_ray_limits_box`, `batched_linspace`, `generate_planes`,
  `project_onto_planes`, `sample_from_planes` (bilinear zero-padded
  sampling of (N, 3, C, H, W) planes at coordinates scaled by 2/box_warp),
  `pack_planes_for_sampling` / `sample_from_packed_planes` (the same on a
  channel-last zero-bordered table: the plain version of K5), and
  `make_kernel_plane_sampler` (K5, `ops/kernels/triplane_gather.py`);
- `OSGDecoder`: mean over planes -> FC(32 -> 64) softplus -> FC(64 -> 4);
  rgb = sigmoid(x) * 1.002 - 0.001, raw sigma;
- `mip_ray_march`: midpoint colours/densities/depths, softplus(sigma - 1),
  alpha compositing, depth = weighted mean -> nan -> inf -> clamped to the
  min/max depth of the whole chunk, optional white background;
- `importance_render`: ray-box limits for ray_start='auto', stratified
  coarse depths, coarse march, max- then avg-pooled weights + 0.01 ->
  deterministic `sample_pdf` -> depth-sorted union -> fine march;
- `TriPlaneGenerator` (StyleGAN2 backbone, 96 channels = 3 x 32 planes,
  mapping with c-conditioning) and `EG3DRenderer` (a learnable latent z),
  `eg3d_render`, `eg3d_sample`.
Deterministic only (the eval path): the stochastic strata, density noise
and random StyleGAN noise come with EG3D training.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_siren_tpu_torch.models.stylegan2 import FullyConnected, Generator, GeneratorConfig
from nerf_siren_tpu_torch.ops.grid_sample import (grid_sample_2d, grid_sample_2d_packed,
                                                  pack_grid_for_block_sample)
from nerf_siren_tpu_torch.ops.kernels.triplane_gather import (PLANE_AXES, project_to_planes,
                                                              triplane_gather)
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf


# -- math utils (reference: volumetric_rendering/math_utils.py) ----------------

def get_ray_limits_box(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       box_side_length: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against the centred cube of side `box_side_length`:
    (t_min, t_max), each (..., 1), with (-1, -2) for rays that miss it."""
    half = box_side_length / 2.0
    invdir = 1.0 / rays_d
    lo = (-half - rays_o) * invdir
    hi = (half - rays_o) * invdir
    tsmall, tbig = torch.minimum(lo, hi), torch.maximum(lo, hi)
    tmin = tsmall[..., :2].amax(-1)
    tmax = tbig[..., :2].amin(-1)
    valid = ~(tsmall[..., 0] > tbig[..., 1]) & ~(tsmall[..., 1] > tbig[..., 0])
    valid &= ~(tmin > tbig[..., 2]) & ~(tsmall[..., 2] > tmax)
    tmin = torch.maximum(tmin, tsmall[..., 2])
    tmax = torch.minimum(tmax, tbig[..., 2])
    tmin = torch.where(valid, tmin, -1.0)
    tmax = torch.where(valid, tmax, -2.0)
    return tmin[..., None], tmax[..., None]


def batched_linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """(num, *start.shape) evenly spaced (reference math_utils.py:101-118)."""
    steps = torch.arange(num, dtype=torch.float32, device=start.device) / (num - 1)
    steps = steps.reshape(-1, *([1] * start.ndim))
    return start[None] + steps * (stop - start)[None]


# -- plane projection (reference: renderer.py:23-65) ---------------------------

def generate_planes() -> np.ndarray:
    return np.asarray([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                       [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                       [[0, 0, 1], [1, 0, 0], [0, 1, 0]]], np.float32)


def project_onto_planes(coordinates: torch.Tensor) -> torch.Tensor:
    """(N, M, 3) -> (N*3, M, 2) plane-local xy coordinates: the first two
    columns of coordinates @ inv(plane). The inverses are permutation
    matrices, so the product is the selection of two axes per plane
    (`PLANE_AXES`, K5's `project_to_planes`), equal to it for every finite
    coordinate."""
    n, m, _ = coordinates.shape
    return project_to_planes(coordinates).transpose(0, 1).reshape(n * len(PLANE_AXES), m, 2)


def sample_from_planes(plane_features: torch.Tensor, coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """plane_features (N, 3, C, H, W), coordinates (N, M, 3) -> (N, 3, M, C)."""
    n, n_planes, c, h, w = plane_features.shape
    m = coordinates.shape[1]
    proj = project_onto_planes((2.0 / box_warp) * coordinates)
    out = grid_sample_2d(plane_features.reshape(n * n_planes, c, h, w), proj)
    return out.reshape(n, n_planes, m, c)


def pack_planes_for_sampling(plane_features: torch.Tensor,
                             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, 3, C, H, W) -> (N, 3, H+2, W+2, C) sampling table, once per
    frame; pairs with sample_from_packed_planes and the K5 sampler. An f32
    table reproduces sample_from_planes bit for bit."""
    n, n_planes, c, h, w = plane_features.shape
    packed = pack_grid_for_block_sample(plane_features.reshape(n * n_planes, c, h, w), dtype)
    return packed.reshape(n, n_planes, h + 2, w + 2, c)


def sample_from_packed_planes(packed: torch.Tensor, coordinates: torch.Tensor,
                              box_warp: float) -> torch.Tensor:
    """sample_from_planes on a pack_planes_for_sampling table: the
    `--plane_sampler gather` route, and K5's plain version."""
    n, n_planes, hp, wp, c = packed.shape
    m = coordinates.shape[1]
    proj = project_onto_planes((2.0 / box_warp) * coordinates)
    out = grid_sample_2d_packed(packed.reshape(n * n_planes, hp, wp, c), proj)
    return out.reshape(n, n_planes, m, c)


def make_kernel_plane_sampler(packed: torch.Tensor,
                              box_warp: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The triplane sampler on the gather kernel K5 (`csrc/triplane_gather.cu`).

    packed: pack_planes_for_sampling table (1, 3, H+2, W+2, C).
    Returns sample(coordinates (1, M, 3)) -> (1, 3, M, C) float32, exactly
    sample_from_packed_planes (on a CPU table it runs that plain version).
    The JAX sampler's TPU tunables (rb, sb, tile_h, tile_px, miss_cap_frac)
    have no counterpart: the kernel gathers every point directly, so the
    port has no miss list, no fallback and no `last_miss_groups`."""
    n, n_planes = packed.shape[:2]
    if n != 1 or n_planes != len(PLANE_AXES):
        raise ValueError(f"kernel sampler: a (1, 3, H+2, W+2, C) table, got {tuple(packed.shape)}")
    table = packed[0].contiguous()
    scale = 2.0 / box_warp

    def sample(coordinates: torch.Tensor) -> torch.Tensor:
        return triplane_gather(table, coordinates[0].contiguous(), scale)[None]
    return sample


# -- OSGDecoder (reference: triplane.py:144-167) -------------------------------

class OSGDecoder(nn.Module):
    def __init__(self, n_features: int = 32, hidden: int = 64, out_dim: int = 3, *,
                 generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.fc1 = FullyConnected(n_features, hidden, **kw)
        self.fc2 = FullyConnected(hidden, 1 + out_dim, **kw)

    def forward(self, sampled_features: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(N, 3, M, C) -> {'rgb': (N, M, 3), 'sigma': (N, M, 1)}."""
        x = sampled_features.mean(dim=1)
        x = self.fc2(F.softplus(self.fc1(x)))
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
        return {"rgb": rgb, "sigma": x[..., 0:1]}


# -- MipRayMarcher2 (reference: ray_marcher.py:20-63) --------------------------

def mip_ray_march(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
                  white_back: bool = False):
    """colors (N, R, S, C), densities (N, R, S, 1), depths (N, R, S, 1) ->
    (rgb (N, R, C), depth (N, R, 1), weights (N, R, S-1, 1))."""
    d = depths[..., 0]
    deltas = d[:, :, 1:] - d[:, :, :-1]
    colors_mid = 0.5 * (colors[:, :, :-1] + colors[:, :, 1:])
    densities_mid = 0.5 * (densities[..., 0][:, :, :-1] + densities[..., 0][:, :, 1:])
    depths_mid = 0.5 * (d[:, :, :-1] + d[:, :, 1:])

    densities_mid = F.softplus(densities_mid - 1.0)
    alpha = 1.0 - torch.exp(-densities_mid * deltas)
    shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1 - alpha + 1e-10], dim=-1)
    weights = alpha * torch.cumprod(shifted, dim=-1)[:, :, :-1]

    composite_rgb = (weights[..., None] * colors_mid).sum(dim=-2)
    weight_total = weights.sum(dim=-1, keepdim=True)
    composite_depth = (weights * depths_mid).sum(dim=-1, keepdim=True) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    # the clip range is the whole chunk's, as in the reference
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())
    if white_back:
        composite_rgb = composite_rgb + 1 - weight_total
    return composite_rgb, composite_depth, weights[..., None]


# -- ImportanceRenderer (reference: renderer.py:82-256) ------------------------

@dataclasses.dataclass(frozen=True)
class RenderingOptions:
    depth_resolution: int = 64
    depth_resolution_importance: int = 64
    ray_start: Any = 0.1          # float or 'auto'
    ray_end: Any = 10.0
    box_warp: float = 15.0
    white_back: bool = False
    disparity_space_sampling: bool = False
    density_noise: float = 0.0


def sample_stratified(ray_origins: torch.Tensor, ray_start, ray_end, depth_resolution: int,
                      disparity: bool = False) -> torch.Tensor:
    """(N, R, S, 1) deterministic depths (reference renderer.py:172-195)."""
    n, r, _ = ray_origins.shape
    kw = dict(dtype=torch.float32, device=ray_origins.device)
    if disparity:
        d = torch.linspace(0, 1, depth_resolution, **kw).reshape(1, 1, -1, 1)
        d = d.expand(n, r, depth_resolution, 1)
        return 1.0 / (1.0 / ray_start * (1 - d) + 1.0 / ray_end * d)
    if isinstance(ray_start, torch.Tensor) and ray_start.ndim > 0:
        d = batched_linspace(ray_start, ray_end, depth_resolution)     # (S, N, R, 1)
        return d.permute(1, 2, 0, 3)
    d = torch.linspace(ray_start, ray_end, depth_resolution, **kw).reshape(1, 1, -1, 1)
    return d.expand(n, r, depth_resolution, 1)


def sample_importance(z_vals: torch.Tensor, weights: torch.Tensor,
                      n_importance: int) -> torch.Tensor:
    """Pool-smoothed deterministic resampling (reference renderer.py:217-239)."""
    n, r, s, _ = z_vals.shape
    z = z_vals.reshape(n * r, s)
    w = weights.reshape(n * r, -1)
    # max_pool1d(kernel 2, stride 1, padding 1), then avg_pool1d(2, 1)
    w_pad = F.pad(w, [1, 1], value=float("-inf"))
    w_max = torch.maximum(w_pad[:, :-1], w_pad[:, 1:])
    w_s = 0.5 * (w_max[:, :-1] + w_max[:, 1:]) + 0.01
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    samples = sample_pdf(z_mid, w_s[:, 1:-1], n_importance, det=True)
    return samples.detach().reshape(n, r, n_importance, 1)


def unify_samples(d1, c1, s1, d2, c2, s2):
    """Depth-sorted union of two sample sets, sigma and colours carried
    along by one stable sort (reference renderer.py:149-170)."""
    depths = torch.cat([d1, d2], dim=-2)
    colors = torch.cat([c1, c2], dim=-2)
    sigmas = torch.cat([s1, s2], dim=-2)
    depths, order = torch.sort(depths[..., 0], dim=-1, stable=True)
    order = order[..., None]
    return (depths[..., None], colors.gather(2, order.expand_as(colors)),
            sigmas.gather(2, order))


def run_model(planes: torch.Tensor, decoder: OSGDecoder, sample_coordinates: torch.Tensor,
              options: RenderingOptions, packed: bool = False,
              sampler: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """(reference renderer.py:144-150). packed=True: `planes` is a
    pack_planes_for_sampling table; `sampler` (make_kernel_plane_sampler)
    overrides both. Deterministic: density_noise is a training option."""
    if sampler is not None:
        feats = sampler(sample_coordinates)
    else:
        sample = sample_from_packed_planes if packed else sample_from_planes
        feats = sample(planes, sample_coordinates, options.box_warp)
    return decoder(feats)


def importance_render(planes: torch.Tensor, decoder: OSGDecoder, ray_origins: torch.Tensor,
                      ray_directions: torch.Tensor, options: RenderingOptions,
                      packed: bool = False, sampler: Optional[Callable] = None):
    """Coarse + fine triplane render (reference renderer.py:88-142).

    planes (N, 3, C, H, W), or a pack_planes_for_sampling table when
    packed=True; rays (N, R, 3). Returns (rgb_coarse, depth_coarse,
    opacity_coarse, rgb_fine, depth_fine, opacity_fine), the opacities
    summed over samples."""
    if options.ray_start == "auto":
        ray_start, ray_end = get_ray_limits_box(ray_origins, ray_directions, options.box_warp)
        valid = (ray_end > ray_start)[..., 0]
        safe_min = torch.where(valid, ray_start[..., 0], float("inf")).min()
        safe_max = torch.where(valid, ray_start[..., 0], float("-inf")).max()
        ray_start = torch.where(valid[..., None], ray_start, safe_min)
        ray_end = torch.where(valid[..., None], ray_end, safe_max)
        depths_coarse = sample_stratified(ray_origins, ray_start, ray_end,
                                          options.depth_resolution,
                                          options.disparity_space_sampling)
    else:
        depths_coarse = sample_stratified(ray_origins, options.ray_start, options.ray_end,
                                          options.depth_resolution,
                                          options.disparity_space_sampling)

    n, r, s, _ = depths_coarse.shape
    coords = (ray_origins[:, :, None, :]
              + depths_coarse * ray_directions[:, :, None, :]).reshape(n, -1, 3)
    out = run_model(planes, decoder, coords, options, packed, sampler)
    colors_coarse = out["rgb"].reshape(n, r, s, -1)
    densities_coarse = out["sigma"].reshape(n, r, s, 1)
    rgb_coarse, depth_coarse, weights_coarse = mip_ray_march(
        colors_coarse, densities_coarse, depths_coarse, options.white_back)

    n_imp = options.depth_resolution_importance
    depths_fine = sample_importance(depths_coarse, weights_coarse, n_imp)
    coords = (ray_origins[:, :, None, :]
              + depths_fine * ray_directions[:, :, None, :]).reshape(n, -1, 3)
    out = run_model(planes, decoder, coords, options, packed, sampler)
    colors_fine = out["rgb"].reshape(n, r, n_imp, -1)
    densities_fine = out["sigma"].reshape(n, r, n_imp, 1)

    all_depths, all_colors, all_densities = unify_samples(
        depths_coarse, colors_coarse, densities_coarse,
        depths_fine, colors_fine, densities_fine)
    rgb_fine, depth_fine, weights_fine = mip_ray_march(all_colors, all_densities, all_depths,
                                                       options.white_back)
    return (rgb_coarse, depth_coarse, weights_coarse.sum(dim=2),
            rgb_fine, depth_fine, weights_fine.sum(dim=2))


# -- TriPlaneGenerator / EG3DRenderer (reference: triplane.py, eg3d_renderer.py)

@dataclasses.dataclass(frozen=True)
class TriPlaneConfig:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    plane_resolution: int = 256
    n_planes: int = 3
    plane_channels: int = 32
    mapping_layers: int = 2
    channel_base: int = 32768
    channel_max: int = 512
    c_gen_conditioning_zero: bool = False
    c_scale: float = 1.0
    rendering: RenderingOptions = RenderingOptions()

    @property
    def backbone(self) -> GeneratorConfig:
        return GeneratorConfig(
            z_dim=self.z_dim, c_dim=self.c_dim, w_dim=self.w_dim,
            img_resolution=self.plane_resolution,
            img_channels=self.n_planes * self.plane_channels,
            mapping_layers=self.mapping_layers,
            channel_base=self.channel_base, channel_max=self.channel_max, conv_clamp=None)


class TriPlaneGenerator(nn.Module):
    """StyleGAN2 backbone + OSGDecoder (reference triplane.py)."""

    def __init__(self, cfg: TriPlaneConfig = TriPlaneConfig(), *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = Generator(cfg.backbone, generator=generator, device=device)
        self.decoder = OSGDecoder(cfg.plane_channels, generator=generator, device=device)

    def mapping(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0) -> torch.Tensor:
        """(reference triplane.py:52-55)."""
        if c is not None and self.cfg.c_gen_conditioning_zero:
            c = torch.zeros_like(c)
        if c is not None:
            c = c * self.cfg.c_scale
        return self.backbone.mapping(z, c, truncation_psi=truncation_psi)

    def planes(self, ws: torch.Tensor, noise_mode: str = "const") -> torch.Tensor:
        """ws -> (N, 3, C, H, W) feature planes."""
        img = self.backbone.synthesis(ws, noise_mode=noise_mode)
        return img.reshape(img.shape[0], self.cfg.n_planes, self.cfg.plane_channels,
                           img.shape[-2], img.shape[-1])

    def synthesis(self, ws: torch.Tensor, ray_origins: torch.Tensor,
                  ray_directions: torch.Tensor,
                  noise_mode: str = "const") -> Dict[str, torch.Tensor]:
        """(reference triplane.py:57-68 synthesis2)."""
        out = importance_render(self.planes(ws, noise_mode), self.decoder, ray_origins,
                                ray_directions, self.cfg.rendering)
        return dict(zip(("rgb_coarse", "depth_coarse", "opacity_coarse",
                         "rgb_fine", "depth_fine", "opacity_fine"), out))

    def sample(self, coordinates: torch.Tensor, z: torch.Tensor,
               c: Optional[torch.Tensor] = None,
               truncation_psi: float = 1.0) -> Dict[str, torch.Tensor]:
        """sigma / rgb at any coordinates (reference triplane.py:122-127)."""
        planes = self.planes(self.mapping(z, c, truncation_psi))
        return run_model(planes, self.decoder, coordinates, self.cfg.rendering)


class EG3DRenderer(TriPlaneGenerator):
    """The single-scene EG3D renderer: a learnable latent z (reference
    eg3d_renderer.py:39), N(0, 1) from numpy's RandomState(seed) as in JAX."""

    def __init__(self, cfg: TriPlaneConfig = TriPlaneConfig(), seed: int = 0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(cfg, generator=generator, device=device)
        z = np.random.RandomState(seed).randn(1, cfg.z_dim).astype(np.float32)
        self.z = nn.Parameter(torch.as_tensor(z, device=device))


def eg3d_render(model: EG3DRenderer, ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                noise_mode: str = "const") -> Dict[str, torch.Tensor]:
    """(reference eg3d_renderer.py:47-63): rays (R, 3) -> dict of (R, ...)."""
    out = model.synthesis(model.mapping(model.z), ray_origins[None], ray_directions[None],
                          noise_mode)
    return {k: v[0] for k, v in out.items()}


def eg3d_sample(model: EG3DRenderer, coordinates: torch.Tensor) -> Dict[str, torch.Tensor]:
    """sigma queries for mesh extraction (reference eg3d_renderer.py:65-67)."""
    return model.sample(coordinates[None], model.z)
