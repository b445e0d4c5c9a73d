"""Exact coarse+fine eval renderer on the fused NeRF field.

Counterpart of `nerf_siren_tpu/render/fused.py::render_rays_fused`: the
test_time contract of `render_rays` (sigma-only coarse pass, deterministic
`sample_pdf`, sorted fine pass, white background) with both field passes
on `ops/kernels/fused_mlp.py`. Points are point-major (N, 3); the fine pass
hands the kernel one direction per ray instead of a per-point copy.
"""
from __future__ import annotations

from typing import Dict

import torch

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import Packed, fused_nerf_full, fused_nerf_sigma
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf
from nerf_siren_tpu_torch.render.rendering import composite, stratified_z_vals


def render_rays_fused(packed: Dict[str, Packed], rays: torch.Tensor,
                      cfg: RenderConfig = RenderConfig()) -> Dict[str, torch.Tensor]:
    """Render (R, 8) rays with `pack_model_params` weights.

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
    sigmas = fused_nerf_sigma(packed["coarse"], points(z_vals)).view(r, cfg.n_samples)
    comp_c = composite(sigmas, z_vals, dir_norm)

    # hierarchical resample on the interval midpoints, edge weights dropped
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = sample_pdf(z_mid, comp_c["weights"][:, 1:-1], cfg.n_importance, det=True)
    z_all, _ = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)
    s_all = z_all.shape[1]

    # fine full pass
    raw = fused_nerf_full(packed["fine"], points(z_all), rays_d,
                          samples_per_dir=s_all).view(r, s_all, 4)
    comp_f = composite(raw[..., 3], z_all, dir_norm, raw[..., :3], white_back=cfg.white_back)
    return {
        "opacity_coarse": comp_c["opacity"],
        "rgb_fine": comp_f["rgb"],
        "depth_fine": comp_f["depth"],
        "opacity_fine": comp_f["opacity"],
    }
