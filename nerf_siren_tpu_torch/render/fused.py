"""Exact coarse+fine eval renderer on the fused NeRF field.

Counterpart of `nerf_siren_tpu/render/fused.py::render_rays_fused`: the
test_time contract of `render_rays` (sigma-only coarse pass, deterministic
`sample_pdf`, sorted fine pass, white background) with both field passes
on `ops/kernels/fused_mlp.py`, or on the int8 field
(`ops/kernels/fused_mlp_int8.py`) when the pack is an int8 one (JAX's
`_kernels_for`). Points are point-major (N, 3); the fine pass hands the
kernel one direction per ray instead of a per-point copy.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import Packed, fused_nerf_full, fused_nerf_sigma
from nerf_siren_tpu_torch.ops.kernels.fused_mlp_int8 import (fused_nerf_full_int8,
                                                             fused_nerf_sigma_int8)
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf
from nerf_siren_tpu_torch.render.rendering import composite, stratified_z_vals


def field_kernels(packed_field: Packed) -> Tuple[Callable, Callable]:
    """The (sigma, full) field passes for a pack: an int8 pack
    (`pack_nerf_params_int8`) carries 'q0x' and runs on K4, a bf16 pack on K1."""
    if "q0x" in packed_field:
        return fused_nerf_sigma_int8, fused_nerf_full_int8
    return fused_nerf_sigma, fused_nerf_full


def render_rays_fused(packed: Dict[str, Packed], rays: torch.Tensor,
                      cfg: RenderConfig = RenderConfig()) -> Dict[str, torch.Tensor]:
    """Render (R, 8) rays with `pack_model_params` (or `pack_model_params_int8`) weights.

    Returns opacity_coarse, rgb_fine, depth_fine and opacity_fine."""
    if not (cfg.test_time and cfg.perturb == 0.0 and cfg.noise_std == 0.0
            and cfg.n_importance > 0):
        raise ValueError("render_rays_fused is the deterministic test_time coarse+fine path")
    r = rays.shape[0]
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6].contiguous()
    near, far = rays[:, 6:7], rays[:, 7:8]
    dir_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    def points(z: torch.Tensor) -> torch.Tensor:
        return (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)

    # coarse sigma-only pass -> importance weights
    z_vals = stratified_z_vals(near, far, cfg.n_samples, use_disp=cfg.use_disp)
    sigmas = field_kernels(packed["coarse"])[0](packed["coarse"], points(z_vals)).view(r, cfg.n_samples)
    comp_c = composite(sigmas, z_vals, dir_norm)

    # hierarchical resample on the interval midpoints, edge weights dropped
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, comp_c["weights"][:, 1:-1], cfg.n_importance, det=True)
    z_all, _ = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)
    s_all = z_all.shape[1]

    # fine full pass
    raw = field_kernels(packed["fine"])[1](packed["fine"], points(z_all), rays_d,
                          samples_per_dir=s_all).view(r, s_all, 4)
    comp_f = composite(raw[..., 3], z_all, dir_norm, raw[..., :3], white_back=cfg.white_back)
    return {
        "opacity_coarse": comp_c["opacity"],
        "rgb_fine": comp_f["rgb"],
        "depth_fine": comp_f["depth"],
        "opacity_fine": comp_f["opacity"],
    }
