"""Hierarchical inverse-CDF importance sampling.

Counterpart of `nerf_siren_tpu/ops/sample_pdf.py`, with every edge case of
the reference `sample_pdf`: weights floored by `eps`, a zero-padded CDF,
linspace (or strata-midpoint) u in deterministic mode, searchsorted with
side='right' on the detached CDF, below/above indices clamped to
[0, N_bins-1], and denominators < eps replaced by 1. The JAX package
replaces the gathers with masked reductions, a TPU workaround; here
`torch.searchsorted` + `gather` is the direct form.
"""
from __future__ import annotations

from typing import Optional

import torch

from nerf_siren_tpu_torch.ops.searchsorted import searchsorted


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    det: bool = False,
    eps: float = 1e-5,
    midpoint: bool = False,
    return_density: bool = False,
    u: Optional[torch.Tensor] = None,
):
    """Draw `n_importance` samples per row from the piecewise-constant pdf.

    Args:
      bins: (N_rays, N_bins) sorted positions (interval midpoints). Bins past
        N_weights + 1 are unreachable and ignored.
      weights: (N_rays, N_bins - 1) unnormalised interval weights.
      generator: source of u when `det` is False.
      u: (N_rays, n_importance) uniform draws made beforehand, in place of
        the generator's.
      det: evenly spaced u instead of uniform random u.
      midpoint: with `det`, strata-centred u = (i + .5) / N.
      return_density: also return the normalised pdf density dcdf/dz of
        the bin each sample landed in.
    Returns:
      samples (N_rays, n_importance), or (samples, density).
    """
    n_rays, n_weights = weights.shape
    bins = bins[:, : n_weights + 1]
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)       # (R, W+1)

    kw = dict(dtype=cdf.dtype, device=cdf.device)
    if det:
        if midpoint:
            u = (torch.arange(n_importance, **kw) + 0.5) / n_importance
        else:
            u = torch.linspace(0.0, 1.0, n_importance, **kw)
        u = u.expand(n_rays, n_importance).contiguous()
    elif u is None:
        if generator is None:
            raise ValueError("sample_pdf: a generator (or u) is required when det=False")
        u = torch.rand(n_rays, n_importance, generator=generator, **kw)

    inds = searchsorted(cdf.detach(), u, side="right")
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, n_weights)
    cdf_below, cdf_above = cdf.gather(1, below), cdf.gather(1, above)
    bins_below, bins_above = bins.gather(1, below), bins.gather(1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    samples = bins_below + (u - cdf_below) / denom * (bins_above - bins_below)
    if not return_density:
        return samples
    dz = torch.clamp_min(bins_above - bins_below, eps)
    density = (cdf_above - cdf_below) / dz
    return samples, density
