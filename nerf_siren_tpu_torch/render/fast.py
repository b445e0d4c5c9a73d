"""Proxy-culled fast eval renderer.

Counterpart of `nerf_siren_tpu/render/fast.py`. A tiny density proxy
(`Proxy`: 5-frequency encoding -> H ReLU -> 1), distilled from the field
(`distill_proxy`), scores C uniform candidates per ray; the full field runs
only at K survivors placed by the proxy's expected compositing weight, and
composites them with NeRF's consecutive-difference deltas (or the
proxy-shaped `ratio` quadrature).

- `render_rays_fast`: one call renders (R, 8) rays. With `select='pdf'`, a
  proxy pack and a field pack it runs the kernel route: K3
  (`ops/kernels/proxy_march.py`: march, inverse-CDF placement, survivor
  points) then the field kernel at the survivors, K1 or K4 by pack layout
  (`render.fused.field_kernels`), plus the `cull` and `adaptive` options.
  Otherwise the plain route of the JAX function: `topk` (with
  `refine_mult`) or `pdf` on the port's `sample_pdf`, the field on its
  kernel when a pack is given or the `NeRF` module itself.
- `make_auto_cull_renderer`: frame-global culling of ray blocks with a
  budget from the previous frame, a self-calibrating threshold and the
  dense-frame bypass (single device; the JAX `mesh=` mode is slice 6).
- `make_edge_refined_renderer`: re-renders the silhouette band of a fast
  frame through `render_rays_fused` at 48 + 16 samples.
- `estimate_scene_aabb`: the occupied box from a sigma grid; `scene_box`
  puts a box on a device, once per renderer.

The JAX package compiles one program per frame and pads rays to its
2048-ray tile; here PyTorch runs eagerly and nothing is padded. Selections
that must equal JAX's (`lax.top_k`, `jnp.argsort`) are stable sorts, which
break ties by the lower index as those do.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.models.layers import init_linear, linear
from nerf_siren_tpu_torch.ops.kernels.proxy_march import proxy_march_select, proxy_opacity
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf
from nerf_siren_tpu_torch.render.fused import field_kernels, render_rays_fused
from nerf_siren_tpu_torch.render.rendering import _field, _n_freqs
from nerf_siren_tpu_torch.utils import tracing

PROXY_FREQS = 5   # 3 * (2 * 5 + 1) = 33 input channels
TILE_R = 2048     # the auto-cull budget quantum, in rays (the JAX kernel's ray tile)

Outputs = Dict[str, torch.Tensor]


# ---- the density proxy -------------------------------------------------------

class Proxy(nn.Module):
    """Density proxy: l1 (33 -> hidden), l2 (hidden -> 1), torch-layout
    `nn.Linear`s (`convert.proxy_to_jax` gives the JAX {'l1', 'l2'} tree)."""

    def __init__(self, hidden: int = 48, *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.l1 = init_linear(3 * (2 * PROXY_FREQS + 1), hidden, **kw)
        self.l2 = init_linear(hidden, 1, **kw)


def init_proxy(hidden: int = 48, generator: Optional[torch.Generator] = None,
               device=None) -> Proxy:
    return Proxy(hidden, generator=generator, device=device)


def apply_proxy(proxy: Proxy, xyz: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """Proxy density score for (..., 3) points -> (...,)."""
    emb = positional_encoding(xyz, PROXY_FREQS)
    h = torch.relu(linear(proxy.l1, emb, compute_dtype))
    return linear(proxy.l2, h, compute_dtype)[..., 0]


def distill_proxy(sigma_fn: Callable[[torch.Tensor], torch.Tensor], aabb_min, aabb_max,
                  generator: torch.Generator, steps: int = 1000, batch: int = 32768,
                  lr: float = 5e-3, hidden: int = 96,
                  overpredict_weight: float = 16.0) -> Proxy:
    """Fit the proxy to log1p(relu(sigma)) of the field over the AABB.

    sigma_fn: (N, 3) -> (N,) raw sigma of the field, on `generator`'s
    device. Each Adam step draws `batch` uniform points and re-samples half
    the batch as jittered copies (5% of the extent) of the densest of them;
    the regression weights occupied targets by 1 + target, and
    `overpredict_weight` penalises over-prediction (phantom density in
    empty space, which starves the expected-weight ranking). The JAX
    function's steps, loss and Adam (optax defaults = torch defaults); the
    random streams are the generator's."""
    device = generator.device
    lo = torch.as_tensor(aabb_min, dtype=torch.float32, device=device)
    hi = torch.as_tensor(aabb_max, dtype=torch.float32, device=device)
    extent = hi - lo
    proxy = init_proxy(hidden, generator=generator, device=device)
    opt = torch.optim.Adam(proxy.parameters(), lr=lr)

    def target(pts):
        return torch.log1p(torch.relu(sigma_fn(pts)))

    for _ in range(steps):
        with torch.no_grad():
            uniform = lo + torch.rand((batch, 3), generator=generator, device=device) * extent
            t_uniform = target(uniform)
            dense = torch.argsort(-t_uniform, stable=True)[: batch // 2]
            seeds = uniform[dense]
            jitter = torch.randn(seeds.shape, generator=generator, device=device) * (0.05 * extent)
            focus = torch.minimum(torch.maximum(seeds + jitter, lo), hi)
            pts = torch.cat([uniform, focus])
            tgt = torch.cat([t_uniform, target(focus)])
        err = apply_proxy(proxy, pts, None) - tgt
        loss = (1.0 + tgt) * err ** 2
        if overpredict_weight != 1.0:
            loss = loss * torch.where(err > 0, overpredict_weight, 1.0)
        opt.zero_grad(set_to_none=True)
        loss.mean().backward()
        opt.step()
    return proxy


def estimate_scene_aabb(sigma_fn: Callable[[torch.Tensor], torch.Tensor], search_min,
                        search_max, resolution: int = 64, threshold: float = 5.0,
                        margin: float = 0.05, chunk: int = 65536):
    """Bounding box of the occupied region: probe a coarse sigma grid and
    take the extent of cells above `threshold`, padded by `margin` of the
    search range; the full search box when nothing exceeds it. sigma_fn
    takes (N, 3) float32 CPU points (it moves them where it runs)."""
    lo = np.asarray(search_min, np.float32)
    hi = np.asarray(search_max, np.float32)
    axes = [np.linspace(lo[i], hi[i], resolution, dtype=np.float32) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    sigma = np.concatenate([
        sigma_fn(torch.from_numpy(pts[i: i + chunk])).detach().float().cpu().numpy().reshape(-1)
        for i in range(0, len(pts), chunk)])
    occ = pts[sigma > threshold]
    if len(occ) == 0:
        return lo, hi
    pad = margin * (hi - lo)
    return np.maximum(occ.min(0) - pad, lo), np.minimum(occ.max(0) + pad, hi)


# ---- render_rays_fast --------------------------------------------------------

def scene_box(scene_aabb, device) -> torch.Tensor:
    """The box ((3,) lo, (3,) hi) as one (2, 3) float32 tensor on `device`
    (a tensor box already there is returned as it is). A copy from host
    memory waits for the device, so the frame renderers make the box once,
    when they are built."""
    if isinstance(scene_aabb, torch.Tensor):
        return scene_aabb.to(device, torch.float32)
    return torch.tensor(np.stack([np.asarray(scene_aabb[0], np.float32),
                                  np.asarray(scene_aabb[1], np.float32)]), device=device)


def _resident(scene_aabb, device) -> bool:
    """Whether the box is float32 tensors on `device`: a (2, 3) tensor or a
    pair of (3,) ones."""
    parts = (scene_aabb,) if isinstance(scene_aabb, torch.Tensor) else scene_aabb[:2]
    return all(isinstance(b, torch.Tensor) and b.device == device and b.dtype == torch.float32
               for b in parts)


def _clip_to_aabb(rays_o, rays_d, near, far, scene_aabb):
    """Tighten each ray's [near, far] to its intersection with the box;
    rays that miss it keep their bounds. Returns (near, far, hits): hits
    (R, 1) is true where a ray's interval meets the box. A box of float32
    tensors on the rays' device is read as it is (counter
    `fast.box_resident`); any other box is copied there first
    (`fast.box_copies`: from host memory the copy waits for the device)."""
    if _resident(scene_aabb, rays_o.device):
        tracing.count("fast.box_resident", 1)
        lo, hi = scene_aabb[0], scene_aabb[1]
    else:
        tracing.count("fast.box_copies", 1)
        lo = torch.tensor(np.asarray(scene_aabb[0], np.float32), device=rays_o.device)
        hi = torch.tensor(np.asarray(scene_aabb[1], np.float32), device=rays_o.device)
    invd = 1.0 / torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9), rays_d)
    t_lo, t_hi = (lo - rays_o) * invd, (hi - rays_o) * invd
    t_min = torch.minimum(t_lo, t_hi).amax(-1, keepdim=True)
    t_max = torch.maximum(t_lo, t_hi).amin(-1, keepdim=True)
    hits = t_max > torch.clamp_min(t_min, 0.0)
    near = torch.where(hits, torch.minimum(torch.maximum(t_min, near), far), near)
    far = torch.where(hits, torch.minimum(torch.maximum(t_max, near), far), far)
    return near, far, hits


def _composite(alphas, z, rgb, white_back):
    """(rgb, depth, opacity, weights) of K samples per ray."""
    trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    weights = alphas * trans
    opacity = weights.sum(-1)
    out_rgb = (weights[..., None] * rgb).sum(-2)
    if white_back:
        out_rgb = out_rgb + (1.0 - opacity[..., None])
    return out_rgb, (weights * z).sum(-1), opacity, weights


def _ratio_alphas(sigmas, dir_norm, rho, mass, n_keep):
    """Proxy-shaped stratum quadrature: each of the K equal-mass strata of
    the proxy CDF (mass W, clamped below 1) has proxy optical depth
    tau_k = ln((1 - c_k) / (1 - c_{k+1})), c_k = k W / K; scale it by the
    field / implied-proxy density ratio at the sample."""
    kk = torch.arange(n_keep, dtype=torch.float32, device=sigmas.device)
    w = torch.clamp_max(mass, 0.9999)
    c0, c1 = kk / n_keep * w, (kk + 1.0) / n_keep * w
    tau = torch.log(torch.clamp_min(1.0 - c0, 1e-7) / torch.clamp_min(1.0 - c1, 1e-7))
    sig_impl = rho * w / torch.clamp_min(1.0 - (kk + 0.5) / n_keep * w, 1e-7)
    ratio = sigmas * dir_norm / torch.clamp_min(sig_impl, 1e-7)
    return 1.0 - torch.exp(-torch.clamp(ratio, 0.0, 1e3) * tau)


def _descending(v: torch.Tensor) -> torch.Tensor:
    """Indices sorting v from largest to smallest, ties by the lower index
    (`jnp.argsort(-v)`, `lax.top_k`)."""
    return torch.argsort(v, dim=-1, descending=True, stable=True)


def render_rays_fast(
    models: Optional[Dict[str, nn.Module]],
    proxy: Optional[Proxy],
    rays: torch.Tensor,
    *,
    n_candidates: int = 192,
    n_keep: int = 32,
    model: str = "fine",
    white_back: bool = False,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    scene_aabb=None,
    refine_mult: int = 1,
    select: str = "topk",
    packed_params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    packed_proxy: Optional[Dict[str, torch.Tensor]] = None,
    adaptive: Optional[Tuple[float, int]] = None,
    cull: Optional[float] = None,
    placement: str = "mid",
    quadrature: str = "delta",
    return_samples: bool = False,
) -> Outputs:
    """Proxy-culled single-pass render: rays (R, 8) -> rgb/depth/opacity_<model>.

    The arguments are the JAX function's (its `nerf_cfg` and frequencies are
    the `NeRF` module's own config here). scene_aabb: ((3,), (3,)) box that
    tightens [near, far]; a `scene_box` on the rays' device is read without
    a copy (a host box is copied each call, which waits for the device).
    select: 'topk' keeps the n_keep candidates of highest expected weight;
    'pdf' places them by the proxy weights' inverse CDF (placement 'mid'
    u = (k + .5)/K, or 'edges' u = k/(K-1)).
    quadrature: 'delta' (consecutive differences, last delta one candidate
    interval) or 'ratio' (needs pdf and mid). packed_params: field packs
    (K1 or K4) for the survivors. packed_proxy (with pdf and packed_params):
    the kernel route on K3, which also serves `cull` (the active fraction of
    rays, ranked by the proxy-opacity prepass; the rest composite to
    background) and `adaptive` ((hi_fraction, k_hi): re-render the most
    ambiguous rays at k_hi). return_samples adds z_samples, w_samples and
    rgb_samples (not with cull or adaptive)."""
    if quadrature == "ratio" and not (select == "pdf" and placement == "mid"):
        raise ValueError("quadrature='ratio' needs equal-mass strata (select='pdf', "
                         "placement='mid')")
    kernel_route = select == "pdf" and packed_proxy is not None and packed_params is not None
    if kernel_route and return_samples and (cull is not None or adaptive is not None):
        raise ValueError("return_samples is unsupported with cull/adaptive")
    if kernel_route and cull is not None and adaptive is not None:
        raise ValueError("cull and adaptive are exclusive")
    r = rays.shape[0]
    with tracing.span("fast.clip"):
        rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
        near, far = rays[:, 6:7], rays[:, 7:8]
        dir_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        tracing.count("fast.rays", r)
        if scene_aabb is not None:
            near, far, hits = _clip_to_aabb(rays_o, rays_d, near, far, scene_aabb)
            tracing.count_device("fast.rays_in_box", hits)
        else:   # no box: every ray's interval is the scene's
            tracing.count("fast.rays_in_box", r)
        if kernel_route:
            rays8 = torch.cat([rays[:, :6], near, far], dim=1).contiguous()

    if kernel_route:
        full_fn = field_kernels(packed_params[model])[1]
        ratio_quad = quadrature == "ratio"

        def fused_pdf(rays8, k):
            """K3 march + placement, the field at the survivors, compositing."""
            with tracing.span("fast.march"):
                sel = proxy_march_select(packed_proxy, rays8, n_candidates, k,
                                         midpoint=placement == "mid", return_density=ratio_quad)
                zs, xyz = sel[0], sel[1]
            with tracing.span("fast.field"):
                raw = full_fn(packed_params[model], xyz.reshape(-1, 3),
                              rays8[:, 3:6].contiguous(), samples_per_dir=k).view(-1, k, 4)
            with tracing.span("fast.composite"):
                sigmas = torch.relu(raw[..., 3])
                dirn = torch.linalg.norm(rays8[:, 3:6], dim=-1, keepdim=True)
                if ratio_quad:
                    alphas = _ratio_alphas(sigmas, dirn, sel[2], sel[3][:, None], k)
                else:
                    spacing = (rays8[:, 7:8] - rays8[:, 6:7]) / (n_candidates - 1)
                    deltas = torch.cat([zs[:, 1:] - zs[:, :-1], spacing], dim=-1) * dirn
                    alphas = 1.0 - torch.exp(-deltas * sigmas)
                rgb, depth, opacity, weights = _composite(alphas, zs, raw[..., :3], white_back)
            return rgb, depth, opacity, zs, weights, raw[..., :3]

        if cull is not None:
            n_act = min(r, max(1, int(cull * r)))
            idx = _descending(proxy_opacity(packed_proxy, rays8, n_candidates))[:n_act]
            rgb_a, depth_a, opac_a = fused_pdf(rays8[idx], n_keep)[:3]
            rgb = torch.full((r, 3), 1.0 if white_back else 0.0, device=rays.device)
            depth = torch.zeros(r, device=rays.device)
            opacity = torch.zeros(r, device=rays.device)
            rgb[idx], depth[idx], opacity[idx] = rgb_a, depth_a, opac_a
            return {f"rgb_{model}": rgb, f"depth_{model}": depth, f"opacity_{model}": opacity}

        rgb, depth, opacity, zs, weights, rgb_k = fused_pdf(rays8, n_keep)
        if adaptive is not None:
            hi_frac, k_hi = adaptive
            n_hi = min(r, max(1, int(hi_frac * r)))
            # ambiguity: world-space spread of the placed depths, gated by opacity
            amb = (zs[:, -1] - zs[:, 0]) * dir_norm[:, 0] * opacity
            idx = _descending(amb)[:n_hi]
            rgb_h, depth_h, opac_h = fused_pdf(rays8[idx], int(k_hi))[:3]
            rgb, depth, opacity = rgb.clone(), depth.clone(), opacity.clone()
            rgb[idx], depth[idx], opacity[idx] = rgb_h, depth_h, opac_h
        out = {f"rgb_{model}": rgb, f"depth_{model}": depth, f"opacity_{model}": opacity}
        if return_samples:
            out.update(z_samples=zs, w_samples=weights, rgb_samples=rgb_k)
        return out

    # plain route: uniform candidates -> survivors by the proxy's expected weight
    t = torch.linspace(0.0, 1.0, n_candidates, device=rays.device)
    z = near * (1 - t) + far * t                                   # (R, C)
    spacing = (far - near) / (n_candidates - 1)

    def proxy_weights(zc, dz):
        score = apply_proxy(proxy, rays_o[:, None, :] + rays_d[:, None, :] * zc[..., None],
                            compute_dtype)
        a_hat = 1.0 - torch.exp(-torch.expm1(torch.relu(score.float())) * dz * dir_norm)
        tr = torch.cumprod(1.0 - a_hat + 1e-10, dim=-1)
        tr = torch.cat([torch.ones_like(tr[:, :1]), tr[:, :-1]], dim=-1)
        return a_hat * tr

    def weight_top_k(zc, dz, k):
        idx = torch.sort(_descending(proxy_weights(zc, dz))[:, :k], dim=-1).values
        return zc.gather(1, idx)

    quad_rho = quad_w = None
    if select == "pdf":
        w_hat = proxy_weights(z, spacing)
        z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
        if quadrature == "ratio":
            # ascending strata-centred u: already sorted, aligned with the densities
            z_sel, quad_rho = sample_pdf(z_mid, w_hat[:, 1:-1], n_keep, det=True,
                                         midpoint=True, return_density=True)
            quad_w = torch.clamp_max((w_hat[:, 1:-1] + 1e-5).sum(-1, keepdim=True), 0.9999)
        else:
            z_sel = sample_pdf(z_mid, w_hat[:, 1:-1], n_keep, det=True,
                               midpoint=placement == "mid")
            z_sel = torch.sort(z_sel, dim=-1).values
    elif refine_mult > 1:
        # split each survivor interval into refine_mult sub-candidates, re-rank
        z_coarse = weight_top_k(z, spacing, n_keep)
        offs = (torch.linspace(-0.5, 0.5, refine_mult + 1, device=rays.device)[:-1]
                + 0.5 / refine_mult)
        z_sub = z_coarse[..., None] + offs * spacing[..., None]
        z_sub = torch.sort(z_sub.reshape(r, -1), dim=-1).values
        z_sel = weight_top_k(z_sub, spacing / refine_mult, n_keep)
        spacing = spacing / refine_mult
    else:
        z_sel = weight_top_k(z, spacing, n_keep)

    xyz_sel = rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None]
    if packed_params is not None:
        raw = field_kernels(packed_params[model])[1](
            packed_params[model], xyz_sel.reshape(-1, 3), rays_d.contiguous(),
            samples_per_dir=n_keep).view(r, n_keep, 4)
    else:
        net = models[model]
        dir_emb = positional_encoding(rays_d, _n_freqs(net.cfg.in_channels_dir))
        raw = _field(net, xyz_sel, dir_emb, compute_dtype)
    sigmas = torch.relu(raw[..., 3])
    if quad_rho is not None:
        alphas = _ratio_alphas(sigmas, dir_norm, quad_rho, quad_w, n_keep)
    else:
        deltas = torch.cat([z_sel[:, 1:] - z_sel[:, :-1], spacing], dim=-1) * dir_norm
        alphas = 1.0 - torch.exp(-deltas * sigmas)
    rgb, depth, opacity, weights = _composite(alphas, z_sel, raw[..., :3], white_back)
    out = {f"rgb_{model}": rgb, f"depth_{model}": depth, f"opacity_{model}": opacity}
    if return_samples:
        out.update(z_samples=z_sel, w_samples=weights, rgb_samples=raw[..., :3])
    return out


# ---- whole-frame drivers -----------------------------------------------------

def make_edge_refined_renderer(
    base_render: Callable[[torch.Tensor], Outputs],
    packed: Dict[str, Dict[str, torch.Tensor]],
    img_hw: Tuple[int, int],
    *,
    white_back: bool = False,
    n_samples: int = 48,
    n_importance: int = 16,
    cap_frac: float = 0.04,
    thr: float = 0.03,
    chunk: int = 8192,
    model: str = "fine",
) -> Callable[[torch.Tensor], Outputs]:
    """Silhouette-edge refinement over a full-frame fast renderer.

    Renders the frame with `base_render`, scores every pixel by the
    4-neighbour gradients of its opacity and (half-weighted) opacity-gated
    depth, widened by one 3x3 dilation, and re-renders the top `cap_frac`
    of rays (those scoring above `thr`) through `render_rays_fused` at
    n_samples + n_importance with the bf16 pack `packed`, scattered back.
    Rays must be a scanline-ordered (H*W, 8) frame. `render.last_refined`
    holds the refined-ray count (a device scalar)."""
    h, w = img_hw
    rp = h * w
    chunk = min(chunk, rp)
    n_edge = max(chunk, -(-int(cap_frac * rp) // chunk) * chunk)
    n_edge = min(n_edge, rp // chunk * chunk)
    cfg_lite = RenderConfig(n_samples=n_samples, n_importance=n_importance, perturb=0.0,
                            noise_std=0.0, white_back=white_back, test_time=True)

    def grad4(m):
        dx, dy = (m[:, 1:] - m[:, :-1]).abs(), (m[1:] - m[:-1]).abs()
        return torch.maximum(torch.maximum(F.pad(dx, (0, 1)), F.pad(dx, (1, 0))),
                             torch.maximum(F.pad(dy, (0, 0, 0, 1)), F.pad(dy, (0, 0, 1, 0))))

    def render(rays: torch.Tensor) -> Outputs:
        if rays.shape[0] != rp:
            raise ValueError(f"edge refinement needs the full {img_hw} frame")
        out = dict(base_render(rays))
        rgb, depth, opacity = (out[f"{k}_{model}"] for k in ("rgb", "depth", "opacity"))
        o = opacity.reshape(h, w)
        g = torch.maximum(grad4(o), 0.5 * grad4((depth * opacity).reshape(h, w)))
        g = F.max_pool2d(g[None, None], 3, stride=1, padding=1)[0, 0]   # 3x3 dilation
        score = g.reshape(-1)
        idx = _descending(score)[:n_edge]
        valid = score[idx] > thr
        rays_e = rays[idx]
        outs = [render_rays_fused(packed, rays_e[i: i + chunk], cfg_lite)
                for i in range(0, n_edge, chunk)]
        for key, cur in (("rgb", rgb), ("depth", depth), ("opacity", opacity)):
            new = torch.cat([o_[f"{key}_fine"] for o_ in outs])
            keep = valid[:, None] if new.dim() == 2 else valid
            cur = cur.clone()
            cur[idx] = torch.where(keep, new, cur[idx])
            out[f"{key}_{model}"] = cur
        render.last_refined = valid.sum()
        return out

    render.last_refined = None
    render.n_edge = n_edge
    return render


class _DeferredCount:
    """A device scalar copied to the host without blocking: the copy is
    enqueued after the frame that produces it and read at the next frame,
    by which time it has long completed (the JAX driver's
    `copy_to_host_async`)."""

    def __init__(self, value: torch.Tensor):
        self.value = value.to("cpu", non_blocking=True)
        self.event = None
        if value.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return float(self.value)


def make_auto_cull_renderer(
    models: Optional[Dict[str, nn.Module]],
    proxy: Optional[Proxy],
    *,
    n_candidates: int,
    n_keep: int,
    white_back: bool,
    packed_params: Dict[str, Dict[str, torch.Tensor]],
    packed_proxy: Dict[str, torch.Tensor],
    scene_aabb=None,
    model: str = "fine",
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    margin: float = 1.2,
    opacity_eps="auto",
    levels: int = 16,
    block: int = 128,
    prepass_candidates: Optional[int] = None,
    placement: str = "mid",
    quadrature: str = "delta",
    mesh=None,
) -> Callable[[torch.Tensor], Outputs]:
    """Frame-global empty-ray culling at ray-block granularity.

    Per frame: the K3 opacity prepass (`prepass_candidates` per ray) scores
    every ray; a block of `block` consecutive rays is foreground if any ray
    clears the threshold; the budget is the PREVIOUS frame's foreground
    block count x `margin`, rounded up to a quantum of the frame
    (`levels` buckets of whole TILE_R tiles); the top-budget blocks by their
    best ray render through `render_rays_fast`'s kernel route, the rest
    composite to background. The first frame renders every block.

    opacity_eps='auto' calibrates the threshold each frame from the rendered
    rays: the smaller of the 99.5th percentile of the prepass score among
    rays that rendered empty (field opacity < 0.01) and the 0.5th
    percentile among rays that rendered visibly (> 0.05), on a 1-in-8
    subsample, clipped to [1e-4, 0.95]; a frame with neither keeps the old
    value (2.0, "cull nothing", until one exists).

    Dense-frame bypass: when the budget covers PLAIN_ENTER of the blocks or
    more, frames render every block in order with no prepass; the count of
    field-visible blocks times the field -> proxy ratio of the last culled
    frame (capped at RATIO_MAX) estimates the proxy-space budget, and when
    it falls below PLAIN_EXIT (or after PLAIN_REPROBE_EVERY plain frames)
    the next frame is a full culled frame that measures budget and eps
    anew. Budget counts come from the previous frame through a non-blocking
    copy, never a sync on the frame in flight.

    Mesh mode (`mesh`, a `parallel/mesh.py::Mesh`; JAX's `mesh=`): the rays
    are padded to the shards' padded rows (the frame split evenly, each
    slab rounded up to TILE_R), each device ranks and culls its own
    contiguous slab with its own eps and counts (`Mesh.run`: a stream a
    slab; the models, proxy and packs `replicate`d), and the next
    frame's static budget and the plain-mode estimate take the MAXIMUM
    across the shards.

    `render.last_active_frac`, `.last_plain` and `.last_eps` (per shard in
    mesh mode) describe the last frame. The box goes to each shard's device
    once, here (`scene_box`)."""
    from nerf_siren_tpu_torch.parallel.mesh import replicate, shard_rays

    prepass_c = prepass_candidates or n_candidates
    if TILE_R % block:
        raise ValueError(f"block must divide TILE_R={TILE_R}")
    blocks_per_tile = TILE_R // block
    n_dev = 1 if mesh is None else mesh.size
    common = dict(n_candidates=n_candidates, n_keep=n_keep, white_back=white_back,
                  placement=placement, compute_dtype=compute_dtype, select="pdf", model=model,
                  quadrature=quadrature)
    box = None if scene_aabb is None else scene_box(scene_aabb, packed_proxy["w1"].device)
    # per shard: (models, proxy, field packs, proxy pack, box) on its device
    if mesh is None:
        shards = [(models, proxy, packed_params, packed_proxy, box)]
    else:
        shards = list(zip(*(replicate(x, mesh) for x in (models, proxy, packed_params,
                                                          packed_proxy, box))))
    auto_eps = opacity_eps == "auto"
    bg = 1.0 if white_back else 0.0
    keys = [f"rgb_{model}", f"depth_{model}", f"opacity_{model}"]

    def render_tiles(shard, act, chunk_rays):
        ms, px, pp, ppx, bx = shard
        outs = [render_rays_fast(ms, px, act[i: i + chunk_rays], packed_params=pp,
                                 packed_proxy=ppx, scene_aabb=bx, **common)
                for i in range(0, act.shape[0], chunk_rays)]
        return {k: torch.cat([o[k] for o in outs]) for k in keys}

    def culled_frame(shard, rays8, r, n_act_b, chunk_b, eps_in):
        """Prepass, block ranking, the top n_act_b blocks rendered,
        reassembly, over rays8's first r valid rows. Returns (outputs,
        n_fg_b, eps_next, n_vis_b)."""
        rp = rays8.shape[0]
        nblocks = rp // block
        dev = rays8.device
        rid = torch.arange(rp, device=dev)
        opac = torch.where(rid < r, proxy_opacity(shard[3], rays8, prepass_c),
                           torch.full((rp,), -1.0, device=dev))
        score = opac.view(nblocks, block).amax(1)
        order = _descending(score)[:n_act_b]
        act = rays8.view(nblocks, block * 8)[order].view(-1, 8)
        out = render_tiles(shard, act, chunk_b * block)
        field_op = out[keys[2]]
        valid = (order[:, None] * block + torch.arange(block, device=dev) < r).reshape(-1)
        eps_next = eps_in
        if auto_eps:
            pre = opac.view(nblocks, block)[order].reshape(-1)[::8]
            empty = ((field_op < 0.01) & valid)[::8]
            occ = ((field_op > 0.05) & valid)[::8]
            nan = torch.full_like(pre, float("nan"))
            eps_emp = torch.nanquantile(torch.where(empty, pre, nan), 0.995)
            eps_occ = torch.nanquantile(torch.where(occ, pre, nan), 0.005)
            eps_cal = torch.clamp(torch.fmin(eps_emp, eps_occ), 1e-4, 0.95)
            eps_next = torch.where(torch.isnan(eps_cal), eps_in, eps_cal)
        thr = torch.where(eps_next > 1.0, torch.full_like(eps_next, -0.5), eps_next)
        n_fg_b = (score > thr).sum()
        vis = (field_op > 0.01) & valid
        n_vis_b = vis.view(n_act_b, block).any(1).sum()
        full = {keys[0]: torch.full((nblocks, block, 3), bg, device=dev),
                keys[1]: torch.zeros((nblocks, block), device=dev),
                keys[2]: torch.zeros((nblocks, block), device=dev)}
        for k, v in full.items():
            v[order] = out[k].view(n_act_b, block, *v.shape[2:])
        return ({k: v.reshape(rp, *v.shape[2:])[:r] for k, v in full.items()},
                _DeferredCount(n_fg_b), eps_next, _DeferredCount(n_vis_b))

    def plain_frame(shard, rays8, r, chunk_b):
        """Every block in order, no prepass. Returns (outputs, n_vis_b)."""
        rp = rays8.shape[0]
        out = render_tiles(shard, rays8, chunk_b * block)
        vis = (out[keys[2]] > 0.01) & (torch.arange(rp, device=rays8.device) < r)
        n_vis_b = vis.view(rp // block, block).any(1).sum()
        return {k: v[:r] for k, v in out.items()}, _DeferredCount(n_vis_b)

    # measured break-even of the culling apparatus and its hysteresis
    PLAIN_ENTER, PLAIN_EXIT = 0.70, 0.65
    RATIO_MAX = 32.0               # cap of the field -> proxy block-count ratio
    PLAIN_REPROBE_EVERY = 64       # bounded staleness of ratio / eps in plain mode
    # per shard: the last counts (`_DeferredCount`), eps and field -> proxy ratio
    state = {"n_fg_b": None, "n_vis_b": None, "plain": False, "ratio": [1.0] * n_dev,
             "plain_run": 0,
             "eps": None if auto_eps else [torch.tensor(float(opacity_eps))] * n_dev}

    def render(rays: torch.Tensor) -> Outputs:
        r = rays.shape[0]
        if n_dev > 1:   # each shard's padded rows
            per = -(-r // n_dev)
            rp = -(-per // TILE_R) * TILE_R
        else:
            rp = r + (-r % TILE_R)
        nblocks = rp // block
        quantum_b = -(-nblocks // (levels * blocks_per_tile)) * blocks_per_tile

        def quantized_act(fg_b):
            return max(quantum_b, -(-int(fg_b * margin) // quantum_b) * quantum_b)

        plain = False
        if state["n_fg_b"] is None:
            # first frame (or a re-probe after plain mode): every block,
            # measuring budget, eps and the field -> proxy ratio
            n_act_b = nblocks
            if state["eps"] is None:
                state["eps"] = [torch.tensor(2.0)] * n_dev   # cull nothing until calibrated
        elif state["plain"]:
            n_act_b, plain = nblocks, True
            state["plain_run"] += 1
            if state["plain_run"] >= PLAIN_REPROBE_EVERY:
                plain = False
            elif state["n_vis_b"] is not None:
                est_fg_b = max(c.get() * q for c, q in zip(state["n_vis_b"], state["ratio"]))
                if quantized_act(est_fg_b) / nblocks < PLAIN_EXIT:
                    plain = False       # turned sparse: a full culled frame now
        else:
            fg = [c.get() for c in state["n_fg_b"]]
            vis = [c.get() for c in state["n_vis_b"]]
            state["ratio"] = [min(f / max(v, 1.0), RATIO_MAX) for f, v in zip(fg, vis)]
            n_act_b = quantized_act(int(max(fg)))
            plain = n_act_b / nblocks >= PLAIN_ENTER
        state["plain"] = plain
        if not plain:
            state["plain_run"] = 0
        if plain or n_act_b >= nblocks:
            nblocks = -(-nblocks // quantum_b) * quantum_b   # whole quanta
            rp = nblocks * block
            n_act_b = nblocks
        rays8 = F.pad(rays.float(), (0, 0, 0, rp * n_dev - r))
        slabs = [rays8] if mesh is None else shard_rays(rays8, mesh)
        valid = [max(0, min(rp, r - s * rp)) for s in range(n_dev)]   # real rows a shard

        def frame(s):
            eps = state["eps"][s].to(slabs[s].device)
            if plain:
                out, n_vis_b = plain_frame(shards[s], slabs[s], valid[s], quantum_b)
                return out, None, eps, n_vis_b
            return culled_frame(shards[s], slabs[s], valid[s], n_act_b, quantum_b, eps)

        if mesh is None:
            results = [frame(0)]
        else:
            results = mesh.run([frame] * n_dev, list(range(n_dev)))
        if not plain:
            state["n_fg_b"] = [res[1] for res in results]
        state["eps"] = [res[2] for res in results]
        state["n_vis_b"] = [res[3] for res in results]
        out = {k: torch.cat([res[0][k].to(rays.device) for res in results]) for k in keys}
        render.last_active_frac = n_act_b / nblocks
        render.last_plain = plain
        render.last_eps = state["eps"][0] if mesh is None else state["eps"]
        return out

    render.last_active_frac = None
    render.last_plain = None
    render.last_eps = None
    return render
