"""Semantic volume rendering: per-ray class log-probabilities from a point
network over each tile's weight-sampled point cloud.

Counterpart of `nerf_siren_tpu/render/rendering_3d.py`. The ray march is
`render_rays`'; each rgb pass then
1. keeps the tile's top-K samples by compositing weight (K = min(capacity,
   R * S); a stable sort of -w, so ties go to the lower index, as JAX's
   `argsort`), valid where the weight exceeds the threshold (0.5 at test
   time, 0 in training, or `cls_threshold`);
2. divides their xyz by the valid cloud's Frobenius norm ('frob'), or by
   its per-point RMS ('rms'), held constant (no gradient);
3. runs the point network on the (K, 6) [xyz, rgb] cloud with the mask;
4. scatters the valid points' log-probabilities back to (R, S, C) (zeros
   elsewhere) and composites cls = sum_s w_s cls_s.
The count of valid points stays a device tensor: nothing here reads the
device from the host, so a training step can be captured in a CUDA graph.
Under data parallelism (`data_parallel`, a `parallel/shard_train.py::
DataParallel`) the ranks all-gather the per-ray xyz, rgb and weights, so
every rank builds JAX's one cloud of the global batch (its top-K, its
norm, the point network's batch norm and max-pool), and each keeps the
class outputs of its own rays.
With `no_grad_on_nerf` the NeRF runs without autograd and only the point
network trains (its parameters then get no gradient, which the system
reads as zeros, as JAX's are).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.render.rendering import StepNoise, _field, render_rays


def semantic_from_weights(points: nn.Module, xyz: torch.Tensor, rgbs: torch.Tensor,
                          weights: torch.Tensor, *, n_classes: int, threshold: float,
                          point_capacity: int, point_norm: str = "frob",
                          data_parallel=None) -> torch.Tensor:
    """Steps 1-4 above: xyz, rgbs (R, S, 3), weights (R, S) -> (R, n_classes).
    `points` maps (K, 6) points and a (K,) mask to (K, n_classes)
    log-probabilities. With `data_parallel` the cloud is the global batch's
    and the rows returned this rank's."""
    if data_parallel is not None:
        r_local = xyz.shape[0]
        g = data_parallel.gather_rows
        cls = semantic_from_weights(points, g(xyz), g(rgbs), g(weights), n_classes=n_classes,
                                    threshold=threshold, point_capacity=point_capacity,
                                    point_norm=point_norm)
        return data_parallel.local_rows(cls, r_local)
    r, s, _ = xyz.shape
    n = r * s
    k = min(point_capacity, n)
    w_flat = weights.reshape(n)
    idx = torch.sort(-w_flat, stable=True).indices[:k]
    valid = w_flat[idx] > threshold
    xyz_sel = xyz.reshape(n, 3)[idx]
    rgb_sel = rgbs.reshape(n, 3)[idx]

    with torch.no_grad():   # the cloud's scale is a constant, as the reference's
        sq = (xyz_sel ** 2).sum(-1) * valid
        norm = torch.sqrt(sq.sum().clamp_min(1e-12))
        if point_norm == "rms":
            norm = norm / torch.sqrt(valid.float().sum().clamp_min(1.0))
    pts = torch.cat([xyz_sel / norm, rgb_sel], dim=-1)                   # (K, 6)
    preds = torch.where(valid[:, None], points(pts, valid), 0.0)         # (K, C)
    cls = preds.new_zeros((n, n_classes)).index_copy(0, idx, preds)
    return (weights[..., None] * cls.reshape(r, s, n_classes)).sum(dim=-2)


def render_rays_3d(models: Dict[str, nn.Module], rays: torch.Tensor,
                   cfg: RenderConfig = RenderConfig(),
                   generator: Optional[torch.Generator] = None, *,
                   n_classes: int = 6, point_capacity: int = 8192,
                   no_grad_on_nerf: bool = True,
                   compute_dtype: Optional[torch.dtype] = None,
                   cls_threshold: Optional[float] = None, point_norm: str = "frob",
                   noise: Optional[StepNoise] = None,
                   data_parallel=None) -> Dict[str, torch.Tensor]:
    """`render_rays` of models {'coarse', 'fine' (optional), 'points'} with
    cls_coarse / cls_fine from `semantic_from_weights` on each rgb pass
    (the test-time coarse pass is sigma-only and has none)."""
    threshold = (0.5 if cfg.test_time else 0.0) if cls_threshold is None else cls_threshold

    def field_fn(model, xyz, d_emb):
        with torch.set_grad_enabled(torch.is_grad_enabled() and not no_grad_on_nerf):
            return _field(model, xyz, d_emb, compute_dtype)

    def cls_fn(xyz, rgb, weights):
        return semantic_from_weights(models["points"], xyz, rgb, weights, n_classes=n_classes,
                                     threshold=threshold, point_capacity=point_capacity,
                                     point_norm=point_norm, data_parallel=data_parallel)

    return render_rays(models, rays, cfg, generator, field_fn=field_fn, noise=noise,
                       cls_fn=cls_fn)
