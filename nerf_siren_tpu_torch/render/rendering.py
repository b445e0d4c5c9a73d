"""Volume rendering core.

Counterpart of `nerf_siren_tpu/render/rendering.py`: stratified sampling
linear in depth or disparity, optional perturbation and sigma noise, alpha
compositing with the cumprod transmittance recurrence (last delta 1e10,
``+1e-10`` inside the product), white background, the test-time sigma-only
coarse pass, and hierarchical `sample_pdf` on the interval midpoints with
the two edge weights dropped. Random draws come from an explicit
`torch.Generator`; without one the render is deterministic.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf


def composite(
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    dir_norm: torch.Tensor,
    rgbs: Optional[torch.Tensor] = None,
    *,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    white_back: bool = False,
) -> Dict[str, torch.Tensor]:
    """Alpha-composite raw sigma (R, S) (and rgb (R, S, 3)) along each ray.

    Returns 'weights' (R, S), 'opacity' (R,), and with `rgbs` also
    'rgb' (R, 3) and 'depth' (R,).
    """
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    delta_inf = torch.full_like(deltas[:, :1], 1e10)
    deltas = torch.cat([deltas, delta_inf], dim=-1) * dir_norm

    if noise_std > 0.0 and generator is not None:
        sigmas = sigmas + torch.randn(sigmas.shape, generator=generator, dtype=sigmas.dtype,
                                      device=sigmas.device) * noise_std

    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alphas * trans
    opacity = weights.sum(dim=-1)

    out = {"weights": weights, "opacity": opacity}
    if rgbs is not None:
        rgb = (weights[..., None] * rgbs).sum(dim=-2)
        if white_back:
            rgb = rgb + (1.0 - opacity[..., None])
        out["rgb"] = rgb
        out["depth"] = (weights * z_vals).sum(dim=-1)
    return out


def stratified_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    *,
    use_disp: bool = False,
    perturb: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Coarse depths (R, n_samples) between near/far (R, 1), linear in depth
    or disparity, jittered within strata when `perturb` > 0."""
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)

    if perturb > 0.0 and generator is not None:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
        t = perturb * torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                                 device=z_vals.device)
        z_vals = lower + (upper - lower) * t
    return z_vals


def _n_freqs(in_channels: int) -> int:
    """Frequencies of a 3-channel positional encoding of `in_channels`."""
    return (in_channels // 3 - 1) // 2


def _field(model, xyz, dir_emb, compute_dtype):
    """Embed positions and run the NeRF MLP over a (R, S, 3) slab."""
    xyz_emb = positional_encoding(xyz, _n_freqs(model.cfg.in_channels_xyz))
    if dir_emb is not None:
        dir_emb = dir_emb[:, None, :].expand(*xyz.shape[:-1], dir_emb.shape[-1])
    return model(xyz_emb, dir_emb, compute_dtype)


def render_rays(
    models: Dict[str, Any],
    rays: torch.Tensor,
    cfg: RenderConfig = RenderConfig(),
    generator: Optional[torch.Generator] = None,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Render (R, 8) rays = [origin(3), direction(3), near, far].

    `models` holds 'coarse' and (with n_importance > 0) 'fine' `NeRF`s,
    whose configs fix the encodings' frequencies. Returns
    rgb/depth/opacity_{coarse,fine} (+ cls_* with a semantic head);
    `test_time` drops the coarse rgb pass and keeps only opacity_coarse.
    """
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    dir_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = positional_encoding(rays_d, _n_freqs(models["coarse"].cfg.in_channels_dir))

    z_vals = stratified_z_vals(near, far, cfg.n_samples, use_disp=cfg.use_disp,
                               perturb=cfg.perturb, generator=generator)
    xyz_coarse = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]

    result: Dict[str, torch.Tensor] = {}
    if cfg.test_time:
        sigmas = _field(models["coarse"], xyz_coarse, None, compute_dtype)[..., 0]
        comp = composite(sigmas, z_vals, dir_norm, noise_std=cfg.noise_std,
                         generator=generator)
        result["opacity_coarse"] = comp["opacity"]
    else:
        raw = _field(models["coarse"], xyz_coarse, dir_emb, compute_dtype)
        comp = composite(raw[..., 3], z_vals, dir_norm, raw[..., :3],
                         noise_std=cfg.noise_std, generator=generator,
                         white_back=cfg.white_back)
        result["rgb_coarse"] = comp["rgb"]
        result["depth_coarse"] = comp["depth"]
        result["opacity_coarse"] = comp["opacity"]
        if raw.shape[-1] > 4:
            result["cls_coarse"] = (comp["weights"][..., None] * raw[..., 4:]).sum(dim=-2)
    weights_coarse = comp["weights"]

    if cfg.n_importance > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        z_fine = sample_pdf(z_mid, weights_coarse[:, 1:-1], cfg.n_importance,
                            generator=generator, det=(cfg.perturb == 0.0)).detach()
        z_all, _ = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)
        xyz_fine = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]

        raw = _field(models["fine"], xyz_fine, dir_emb, compute_dtype)
        comp = composite(raw[..., 3], z_all, dir_norm, raw[..., :3],
                         noise_std=cfg.noise_std, generator=generator,
                         white_back=cfg.white_back)
        result["rgb_fine"] = comp["rgb"]
        result["depth_fine"] = comp["depth"]
        result["opacity_fine"] = comp["opacity"]
        if raw.shape[-1] > 4:
            result["cls_fine"] = (comp["weights"][..., None] * raw[..., 4:]).sum(dim=-2)
    return result


def map_chunks(render_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
               rays: torch.Tensor, chunk: int) -> Dict[str, torch.Tensor]:
    """Apply `render_fn` to consecutive `chunk`-ray slices of `rays` and
    concatenate the outputs (the last slice may be shorter)."""
    outs = [render_fn(rays[i: i + chunk]) for i in range(0, rays.shape[0], chunk)]
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def render_rays_chunked(
    models: Dict[str, Any],
    rays: torch.Tensor,
    cfg: RenderConfig = RenderConfig(),
    generator: Optional[torch.Generator] = None,
    **kwargs,
) -> Dict[str, torch.Tensor]:
    """Render any number of rays in `cfg.chunk`-ray tiles. A Python loop
    takes the place of the JAX package's `lax.map`: PyTorch runs eagerly, so
    the tiles need no padding to one static shape."""
    return map_chunks(lambda t: render_rays(models, t, cfg, generator, **kwargs),
                      rays, cfg.chunk)
