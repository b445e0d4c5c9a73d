"""Proxy-culled training renderer (`--train_backend culled|culled_fused`).

Counterpart of `nerf_siren_tpu/render/culled_train.py::render_rays_culled`.
A small density proxy (the fast renderer's `render/fast.py::Proxy`, hidden
64) is trained online with the fields, and it places the samples of each
training step in place of the coarse network's 64-sample pass:
1. C uniform candidates z = near (1 - t) + far t per ray are scored by the
   proxy in bf16 (the plain proxy MLP, `apply_proxy`, as JAX scores them;
   not K3);
2. sigma_hat = expm1(relu(score)), alpha = 1 - exp(-sigma_hat * spacing *
   |d|), spacing (far - near) / (C - 1), weights through the cumprod
   transmittance; `n_sel` depths by `sample_pdf` over the candidates'
   midpoints and the inner weights (deterministic at perturb 0), `n_uni`
   stratified depths as an exploration floor, sorted: K = n_sel + n_uni
   depths a ray, detached (`culled_depths`, a function of the scores);
3. the coarse and the fine field are both evaluated at those K depths and
   composited, each with its own density noise; the `culled_fused` backend
   passes a K2-backed `field_fn`, so both passes launch K2's forward and
   backward with `samples_per_dir` = K;
4. the proxy regresses log1p(relu(sigma_fine)) (detached) at the K points
   in float32, weighted by (1 + target) and by `overpredict_weight` where it
   over-predicts.
No gradient of the photometric loss reaches the proxy: the placement is
detached, so the proxy learns from its regression term alone.

The step's four draws (JAX's `split(rng, 4)`: the pdf's u, the strata,
the coarse and the fine density noise) are a `StepNoise` under their own
names (`noise_shapes`), made beforehand from the step's generator,
so a captured CUDA graph can replay the step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf
from nerf_siren_tpu_torch.render.fast import apply_proxy
from nerf_siren_tpu_torch.render.rendering import (StepNoise, _field, _n_freqs,
                                                   _Transmittance, composite, draw_noise,
                                                   noise_shapes, stratified_z_vals)

PROXY_HIDDEN = 64   # the online proxy's width (JAX: init_proxy(..., hidden=64))


def culled_depths(scores: torch.Tensor, z_cand: torch.Tensor, near: torch.Tensor,
                  far: torch.Tensor, dir_norm: torch.Tensor, n_sel: int, n_uni: int,
                  cfg: RenderConfig, noise: Optional[StepNoise] = None) -> torch.Tensor:
    """The K = n_sel + n_uni sorted, detached depths (R, K) of each ray from
    the proxy's scores (R, C) at the candidates z_cand (R, C); near, far and
    dir_norm (R, 1). `noise` holds the culled draws `noise_shapes` names
    (none at perturb 0)."""
    noise = noise or {}
    c = z_cand.shape[-1]
    spacing = (far - near) / (c - 1)
    sigma_hat = torch.expm1(torch.relu(scores.float()))
    a_hat = 1.0 - torch.exp(-sigma_hat * spacing * dir_norm)
    tr = _Transmittance.apply(1.0 - a_hat + 1e-10)
    tr = torch.cat([torch.ones_like(tr[:, :1]), tr[:, :-1]], dim=-1)
    w_hat = a_hat * tr
    z_mid = 0.5 * (z_cand[:, :-1] + z_cand[:, 1:])
    z_sel = sample_pdf(z_mid, w_hat[:, 1:-1], n_sel, det=(cfg.perturb == 0.0),
                       u=noise.get("culled_pdf_u"))
    z_uni = stratified_z_vals(near, far, n_uni, use_disp=cfg.use_disp, perturb=cfg.perturb,
                              u=noise.get("culled_strat_u"))
    z_all, _ = torch.sort(torch.cat([z_uni, z_sel], dim=-1), dim=-1)
    return z_all.detach()


def render_rays_culled(
    models: Dict[str, Any],
    rays: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    *,
    n_candidates: int = 32,
    n_sel: int = 16,
    n_uni: int = 8,
    overpredict_weight: float = 16.0,
    compute_dtype: Optional[torch.dtype] = None,
    field_fn: Optional[Callable] = None,
    noise: Optional[StepNoise] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One culled training forward: rays (R, 8) -> (outputs, proxy loss).

    `models` holds 'coarse', 'fine' and 'proxy'. The outputs are
    rgb/depth/opacity_{coarse,fine}, which the loss registry takes as
    `render_rays`'s. The draws come from `generator` (made first, in
    `noise_shapes`' order) or are `noise`. `field_fn` as in
    `render_rays`: (model, xyz (R, K, 3), dir_emb (R, Cd)) -> raw (R, K, 4)."""
    if "fine" not in models or "proxy" not in models:
        raise ValueError("culled training needs a fine model and a proxy in models")
    want = noise_shapes(rays.shape[0], cfg, (n_sel, n_uni))
    if noise is None:
        if want and generator is None:
            raise ValueError(f"render_rays_culled draws {list(want)}: pass a generator")
        noise = draw_noise(generator, rays.shape[0], cfg, (n_sel, n_uni)) if want else {}
    elif generator is not None or {k: tuple(v.shape) for k, v in noise.items()} != \
            {k: shape for k, (shape, _) in want.items()}:
        raise ValueError(f"noise: expected the draws {list(want)} at their shapes "
                         "(`noise_shapes`) and no generator")
    if field_fn is None:
        def field_fn(model, xyz, d_emb):
            return _field(model, xyz, d_emb, compute_dtype)

    proxy = models["proxy"]
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    dir_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = positional_encoding(rays_d, _n_freqs(models["coarse"].cfg.in_channels_dir))

    # the proxy's placement (detached)
    t = torch.linspace(0.0, 1.0, n_candidates, dtype=near.dtype, device=near.device)
    z_cand = near * (1.0 - t) + far * t
    xyz_cand = rays_o[:, None, :] + rays_d[:, None, :] * z_cand[..., None]
    with torch.no_grad():
        scores = apply_proxy(proxy, xyz_cand, torch.bfloat16)
    z_all = culled_depths(scores, z_cand, near, far, dir_norm, n_sel, n_uni, cfg, noise)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]

    # both fields at the K survivors
    result: Dict[str, torch.Tensor] = {}
    for key in ("coarse", "fine"):
        raw = field_fn(models[key], xyz, dir_emb)
        comp = composite(raw[..., 3], z_all, dir_norm, raw[..., :3], noise_std=cfg.noise_std,
                         white_back=cfg.white_back, noise=noise.get(f"culled_sigma_{key}"))
        result[f"rgb_{key}"] = comp["rgb"]
        result[f"depth_{key}"] = comp["depth"]
        result[f"opacity_{key}"] = comp["opacity"]

    # the proxy's online regression, float32
    target = torch.log1p(torch.relu(raw[..., 3].detach().float()))   # the fine field's
    pred = apply_proxy(proxy, xyz.detach(), None)
    err = pred - target
    w_reg = (1.0 + target) * torch.where(err > 0, overpredict_weight, 1.0)
    return result, (w_reg * err ** 2).mean()
