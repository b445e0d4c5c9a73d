"""The reference's whole render pipeline in plain torch, an oracle to hold
the port's renderers against.

The port's copy of the torch oracle in the JAX package's
`tests/test_torch_parity.py` (`torch_embedding`, `torch_nerf`,
`torch_sample_pdf`, `torch_composite`, `torch_render`), itself derived
from the reference's published formulas (models/nerf.py:83-124,
models/rendering.py:22-262): embedding -> NeRF MLP -> stratified sampling
-> compositing -> hierarchical `sample_pdf` (deterministic) -> fine pass,
a full (not test_time) float32 render. The weights are JAX-layout NeRF
trees (`{'xyz_layers': [...], 'sigma', ...}`, kernels (in, out), numpy:
`convert.nerf_to_jax`). The one change from the test's version: every
tensor is made on the rays' device, so the oracle runs on a card too; on
the CPU it computes the test's bits.
"""
from __future__ import annotations

import numpy as np
import torch


def torch_embedding(x, n_freqs):
    out = [x]
    for k in range(n_freqs):
        f = 2.0 ** k
        out += [torch.sin(f * x), torch.cos(f * x)]
    return torch.cat(out, -1)


def torch_nerf(params, xyz_emb, dir_emb=None):
    """The reference MLP (models/nerf.py:83-124) on a JAX-layout param tree."""
    def lin(p, h):
        return (h @ torch.tensor(np.asarray(p["kernel"]), device=h.device)
                + torch.tensor(np.asarray(p["bias"]), device=h.device))

    h = xyz_emb
    for i, layer in enumerate(params["xyz_layers"]):
        if i == 4:
            h = torch.cat([xyz_emb, h], -1)
        h = torch.relu(lin(layer, h))
    sigma = lin(params["sigma"], h)
    if dir_emb is None:
        return sigma
    feat = lin(params["xyz_final"], h)
    hd = torch.relu(lin(params["dir_layer"], torch.cat([feat, dir_emb], -1)))
    rgb = torch.sigmoid(lin(params["rgb"], hd))
    return torch.cat([rgb, sigma], -1)


def torch_sample_pdf(bins, weights, n_importance, eps=1e-5):
    """reference models/rendering.py:22-67, det mode."""
    n_rays, n_w = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    u = torch.linspace(0, 1, n_importance, device=bins.device).expand(
        n_rays, n_importance).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, n_w)
    g = torch.stack([below, above], -1).view(n_rays, 2 * n_importance)
    cdf_g = torch.gather(cdf, 1, g).view(n_rays, n_importance, 2)
    bins_g = torch.gather(bins, 1, g).view(n_rays, n_importance, 2)
    denom = cdf_g[..., 1] - cdf_g[..., 0]
    denom[denom < eps] = 1
    return bins_g[..., 0] + (u - cdf_g[..., 0]) / denom * (bins_g[..., 1] - bins_g[..., 0])


def torch_composite(sigmas, z_vals, dir_norm, rgbs, white_back):
    """reference models/rendering.py:162-190."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, 1e10 * torch.ones_like(deltas[:, :1])], -1)
    deltas = deltas * dir_norm
    alphas = 1 - torch.exp(-deltas * torch.relu(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1 - alphas + 1e-10], -1)
    weights = alphas * torch.cumprod(shifted, -1)[:, :-1]
    wsum = weights.sum(1)
    rgb = (weights.unsqueeze(-1) * rgbs).sum(-2)
    depth = (weights * z_vals).sum(-1)
    if white_back:
        rgb = rgb + 1 - wsum.unsqueeze(-1)
    return rgb, depth, weights, wsum


def torch_render(params, rays, n_samples, n_importance, white_back):
    """Full deterministic coarse+fine render (reference rendering.py:70-262)
    of (R, 8) rays with {'coarse': tree, 'fine': tree}."""
    rays_o, rays_d = rays[:, :3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    dir_norm = torch.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = torch_embedding(rays_d, 4)
    n_rays = rays.shape[0]

    z_steps = torch.linspace(0, 1, n_samples, device=rays.device)
    z_vals = (near * (1 - z_steps) + far * z_steps).expand(n_rays, n_samples)

    def run(model_params, z):
        xyz = rays_o.unsqueeze(1) + rays_d.unsqueeze(1) * z.unsqueeze(2)
        s = z.shape[1]
        emb = torch_embedding(xyz.reshape(-1, 3), 10)
        d = dir_emb.repeat_interleave(s, dim=0)
        out = torch_nerf(model_params, emb, d).view(n_rays, s, 4)
        return torch_composite(out[..., 3], z, dir_norm, out[..., :3], white_back)

    rgb_c, depth_c, w_c, op_c = run(params["coarse"], z_vals)
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z_fine = torch_sample_pdf(z_mid, w_c[:, 1:-1], n_importance)
    z_all, _ = torch.sort(torch.cat([z_vals, z_fine], -1), -1)
    rgb_f, depth_f, w_f, op_f = run(params["fine"], z_all)
    return {"rgb_coarse": rgb_c, "depth_coarse": depth_c, "opacity_coarse": op_c,
            "rgb_fine": rgb_f, "depth_fine": depth_f, "opacity_fine": op_f}
