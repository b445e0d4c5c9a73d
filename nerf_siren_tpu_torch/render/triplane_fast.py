"""Proxy-culled fast eval renderer for EG3D triplane scenes.

Counterpart of `nerf_siren_tpu/render/triplane_fast.py`. It reuses the NeRF
fast path's machinery (`render/fast.py`, K3 in `ops/kernels/
proxy_march.py`): the scene's planes are synthesised once per renderer,
its density field is distilled into the small proxy MLP once (or a given
`proxy=` is taken), K3 select scores C uniform candidates per ray and
places K samples by the proxy's deterministic inverse CDF, and only those
K survivors are sampled from the planes (the plain packed gather,
`sample_from_packed_planes`, as the JAX renderer samples them) and decoded
by the OSG decoder: K plane samples a ray in place of the exact
renderer's coarse + fine passes. With cull='auto' the frame also drops
proxy-empty ray blocks before the gather: K3 opacity ranks them, the
budget is the previous frame's foreground count (the temporal
frame-global scheme of `render/fast.py::make_auto_cull_renderer`), with
the dense-frame bypass and its hysteresis (PLAIN_ENTER 0.80, PLAIN_EXIT
0.75), the two-sided `auto` eps and deferred counts (`_DeferredCount`).

Conventions (JAX's, reference eval-time rendering of eg3d_renderer.py
scenes):
- the marcher density is softplus(sigma - 1), what the proxy distils and
  what the composite applies;
- deltas are in depth units, with no direction-norm factor (as
  `mip_ray_march`); the last delta is (far - near) / (C - 1);
- per-ray [near, far] is the box intersection clipped to the numeric
  [ray_start, ray_end] (or to depth 0 for ray_start='auto'); rays that miss
  collapse to a zero-length interval at a safe depth and get zero opacity;
- the depth is the weighted mean over the opacity, clipped to the min/max
  survivor depth of the call's rays.
The TPU kernel's tile-major survivor order and its padding of rays to the
kernel's tile are layout: here the survivors are ray-major (R, K) and no
ray is padded, so the depth clip and the safe depth are taken over the
call's rays. A call renders its rays whole; the survivors' plane samples
and decoder run in slices of DECODE_RAYS rays, which bounds the
temporaries of a whole culled frame and changes no value.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.ops.kernels.proxy_march import (pack_proxy_params, proxy_march_select,
                                                          proxy_opacity)
from nerf_siren_tpu_torch.render.fast import (TILE_R, Proxy, _DeferredCount, _descending,
                                              _ratio_alphas, distill_proxy)
from nerf_siren_tpu_torch.render.triplane import (EG3DRenderer, TriPlaneConfig,
                                                  get_ray_limits_box, pack_planes_for_sampling,
                                                  sample_from_packed_planes, sample_from_planes)

Outputs = Dict[str, torch.Tensor]
KEYS = ("rgb_fine", "depth_fine", "opacity_fine")
DECODE_RAYS = 65536          # rays per slice of the survivors' plane samples and decoder
PLAIN_ENTER, PLAIN_EXIT = 0.80, 0.75   # the dense-frame bypass and its hysteresis


def triplane_sigma_fn(planes: torch.Tensor, decoder, box_warp: float
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(N, 3) points -> the marching density softplus(sigma - 1) of a
    synthesised scene (float32 planes (1, 3, C, H, W)): the distillation
    target."""
    def sigma(pts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = decoder(sample_from_planes(planes, pts[None], box_warp))
            return F.softplus(out["sigma"][0, :, 0] - 1.0)
    return sigma


def fast_rays8(rays: torch.Tensor, opts) -> torch.Tensor:
    """(R, >= 6) rays -> (R, 8) [o, d, near, far] under `opts`
    (`RenderingOptions`): the box intersection, clipped to the numeric
    [ray_start, ray_end] (to depth 0 for 'auto'); rays that miss get a
    zero-length interval at the smallest near of the call's hits."""
    o, d = rays[:, 0:3], rays[:, 3:6]
    start, end = get_ray_limits_box(o[None], d[None], opts.box_warp)
    start, end = start[0, :, 0], end[0, :, 0]
    if isinstance(opts.ray_start, str):
        start = torch.clamp_min(start, 0.0)
    else:
        start = torch.clamp_min(start, opts.ray_start)
        end = torch.clamp_max(end, opts.ray_end)
    valid = end > start
    safe = torch.where(valid, start, float("inf")).min()
    safe = torch.where(torch.isfinite(safe), safe, torch.zeros_like(safe))
    near = torch.where(valid, start, safe)[:, None]
    far = torch.where(valid, end, safe)[:, None]
    return torch.cat([o, d, near, far], dim=1).contiguous()


def make_fast_eg3d_renderer(
    model: EG3DRenderer,
    cfg: TriPlaneConfig,
    *,
    n_candidates: int = 32,
    n_keep: int = 16,
    distill_steps: int = 500,
    distill_batch: int = 32768,
    generator: Optional[torch.Generator] = None,
    table_dtype: torch.dtype = torch.bfloat16,
    cull: Optional[str] = None,
    cull_margin: float = 1.2,
    opacity_eps="auto",
    levels: int = 8,
    block: int = 128,
    prepass_candidates: Optional[int] = None,
    placement: str = "mid",
    proxy: Optional[Proxy] = None,
    quadrature: str = "delta",
) -> Callable[[torch.Tensor], Outputs]:
    """A proxy-culled renderer for ONE synthesised scene (the JAX function's
    arguments; `generator` in place of its rng, on the model's device).

    Synthesises the planes once (a `table_dtype` sampling table), distils
    the proxy over the box of side box_warp (unless `proxy` is given) and
    returns render(rays (R, >= 6) [o, d, ...]) -> {'rgb_fine',
    'depth_fine', 'opacity_fine'}. `render.proxy` is the proxy.

    placement 'mid' takes strata-centred quantiles u = (k + .5) / K, 'edges'
    u = k / (K - 1); quadrature 'ratio' (with 'mid') composites with the
    proxy-shaped stratum quadrature. cull='auto': frame-global culling of
    `block`-ray blocks ranked by the K3 opacity prepass at
    `prepass_candidates`, the budget the previous frame's foreground blocks
    x `cull_margin` in `levels` quanta of whole TILE_R tiles, opacity_eps a
    float or 'auto' (calibrated each frame); `render.last_active_frac`,
    `.last_plain` and `.last_eps` describe the last frame."""
    if quadrature == "ratio" and placement != "mid":
        raise ValueError("quadrature='ratio' needs equal-mass strata (placement='mid')")
    if cull not in (None, "auto"):
        raise ValueError(f"cull must be None or 'auto' (got {cull!r})")
    opts = cfg.rendering
    device = model.z.device
    decoder = model.decoder
    with torch.no_grad():
        planes = model.planes(model.mapping(model.z))
        packed_planes = pack_planes_for_sampling(planes, table_dtype)
    if proxy is None:
        half = 0.5 * opts.box_warp
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        proxy = distill_proxy(triplane_sigma_fn(planes, decoder, opts.box_warp), [-half] * 3,
                              [half] * 3, generator, steps=distill_steps, batch=distill_batch)
    del planes
    packed_proxy = pack_proxy_params(proxy, device)
    c, k = n_candidates, n_keep
    bg = 1.0 if opts.white_back else 0.0

    def decode(xyz: torch.Tensor):
        """Survivors (R, K, 3) -> raw sigma (R, K), rgb (R, K, 3)."""
        r = xyz.shape[0]
        sig, rgb = [], []
        for i in range(0, r, DECODE_RAYS):
            part = xyz[i: i + DECODE_RAYS].reshape(1, -1, 3)
            out = decoder(sample_from_packed_planes(packed_planes, part, opts.box_warp))
            sig.append(out["sigma"][0, :, 0].view(-1, k))
            rgb.append(out["rgb"][0].view(-1, k, 3))
        return torch.cat(sig), torch.cat(rgb)

    def render_core(rays8: torch.Tensor, real: Optional[torch.Tensor] = None):
        """(N, 8) prepped rays -> (rgb, depth, opacity); `real` (N,) marks
        the rays of the frame among block padding (the depth clip's
        range)."""
        sel = proxy_march_select(packed_proxy, rays8, c, k, midpoint=placement == "mid",
                                 return_density=quadrature == "ratio")
        z, xyz = sel[0], sel[1]
        sig, rgb_k = decode(xyz)
        dens = F.softplus(sig - 1.0)                                 # the marcher's activation
        if quadrature == "ratio":
            alphas = _ratio_alphas(dens, 1.0, sel[2], sel[3][:, None], k)
        else:
            spacing = (rays8[:, 7:8] - rays8[:, 6:7]) / (c - 1)
            deltas = torch.cat([z[:, 1:] - z[:, :-1], spacing], dim=-1)
            alphas = 1.0 - torch.exp(-dens * deltas)
        trans = torch.cumprod(1.0 - alphas + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
        weights = alphas * trans
        opacity = weights.sum(-1)
        rgb = (weights[..., None] * rgb_k).sum(-2)
        depth = (weights * z).sum(-1) / torch.clamp_min(opacity, 1e-10)
        zr = z if real is None else z[real]
        depth = torch.clamp(depth, zr.min(), zr.max())
        if opts.white_back:
            rgb = rgb + (1.0 - opacity[:, None])
        return rgb, depth, opacity

    if cull is None:
        @torch.no_grad()
        def render_plain(rays: torch.Tensor) -> Outputs:
            return dict(zip(KEYS, render_core(fast_rays8(rays.float(), opts))))

        render_plain.proxy = proxy
        return render_plain

    prepass_c = prepass_candidates or c
    if TILE_R % block:
        raise ValueError(f"block must divide TILE_R={TILE_R}")
    blocks_per_tile = TILE_R // block
    auto_eps = opacity_eps == "auto"

    def culled_frame(rays8, r, n_act_b, eps_in):
        """Prepass, block ranking, the top n_act_b blocks rendered, block
        reassembly. Returns (outputs, n_fg_b, eps_next, n_vis_b)."""
        rp = rays8.shape[0]
        nblocks = rp // block
        dev = rays8.device
        rid = torch.arange(rp, device=dev)
        opac = torch.where(rid < r, proxy_opacity(packed_proxy, rays8, prepass_c),
                           torch.full((rp,), -1.0, device=dev))
        score = opac.view(nblocks, block).amax(1)
        order = _descending(score)[:n_act_b]
        act = rays8.view(nblocks, block * 8)[order].view(-1, 8)
        valid = (order[:, None] * block + torch.arange(block, device=dev) < r).reshape(-1)
        rgb_a, depth_a, opac_a = render_core(act, valid)
        eps_next = eps_in
        if auto_eps:
            # two-sided: the empty rays' 99.5th percentile bounds false
            # positives, the visible rays' 0.5th false negatives; 1 of 8
            pre = opac.view(nblocks, block)[order].reshape(-1)[::8]
            empty = ((opac_a < 0.01) & valid)[::8]
            occ = ((opac_a > 0.05) & valid)[::8]
            nan = torch.full_like(pre, float("nan"))
            eps_emp = torch.nanquantile(torch.where(empty, pre, nan), 0.995)
            eps_occ = torch.nanquantile(torch.where(occ, pre, nan), 0.005)
            eps_cal = torch.clamp(torch.fmin(eps_emp, eps_occ), 1e-4, 0.95)
            eps_next = torch.where(torch.isnan(eps_cal), eps_in, eps_cal)
        thr = torch.where(eps_next > 1.0, torch.full_like(eps_next, -0.5), eps_next)
        n_fg_b = (score > thr).sum()
        vis = (opac_a > 0.01) & valid
        n_vis_b = vis.view(n_act_b, block).any(1).sum()
        full = (torch.full((nblocks, block, 3), bg, device=dev),
                torch.zeros((nblocks, block), device=dev),
                torch.zeros((nblocks, block), device=dev))
        for buf, v in zip(full, (rgb_a, depth_a, opac_a)):
            buf[order] = v.view(n_act_b, block, *buf.shape[2:])
        return ({key: v.reshape(rp, *v.shape[2:])[:r] for key, v in zip(KEYS, full)},
                n_fg_b, eps_next, n_vis_b)

    def plain_frame(rays8, r):
        """Every ray, no prepass: the plain renderer's frame, and the count
        of field-visible blocks. Returns (outputs, n_vis_b)."""
        rp = rays8.shape[0]
        rgb, depth, opacity = render_core(rays8[:r])
        vis = F.pad(opacity > 0.01, (0, rp - r))
        return dict(zip(KEYS, (rgb, depth, opacity))), vis.view(rp // block, block).any(1).sum()

    state = {"n_fg_b": None, "n_vis_b": None, "plain": False, "ratio": 1.0,
             "eps": None if auto_eps else torch.tensor(float(opacity_eps))}

    @torch.no_grad()
    def render_culled(rays: torch.Tensor) -> Outputs:
        r = rays.shape[0]
        rp = r + (-r % TILE_R)
        nblocks = rp // block
        quantum_b = -(-nblocks // (levels * blocks_per_tile)) * blocks_per_tile

        def quantized_act(fg_b):
            return min(nblocks, max(quantum_b, -(-int(fg_b * cull_margin) // quantum_b)
                                    * quantum_b))

        plain = False
        if state["n_fg_b"] is None:
            # the first frame (or a re-probe): every block, measuring budget,
            # eps and the field -> proxy ratio with the real prepass
            n_act_b = nblocks
            if state["eps"] is None:
                state["eps"] = torch.tensor(2.0)        # cull nothing until calibrated
        elif state["plain"]:
            n_act_b, plain = nblocks, True
            if state["n_vis_b"] is not None:
                est_fg_b = state["n_vis_b"].get() * state["ratio"]
                if quantized_act(est_fg_b) / nblocks < PLAIN_EXIT:
                    plain = False                       # turned sparse: a culled frame now
        else:
            fg, vis = state["n_fg_b"].get(), state["n_vis_b"].get()
            state["ratio"] = fg / max(vis, 1.0)
            n_act_b = quantized_act(int(fg))
            plain = n_act_b / nblocks >= PLAIN_ENTER
        state["plain"] = plain
        rays8 = F.pad(fast_rays8(rays.float(), opts), (0, 0, 0, rp - r))
        eps = state["eps"].to(rays.device)
        if plain:
            out, n_vis_b = plain_frame(rays8, r)
        else:
            out, n_fg_b, eps, n_vis_b = culled_frame(rays8, r, n_act_b, eps)
            state["n_fg_b"] = _DeferredCount(n_fg_b)
        state["n_vis_b"] = _DeferredCount(n_vis_b)
        state["eps"] = eps
        render_culled.last_active_frac = 1.0 if plain else n_act_b / nblocks
        render_culled.last_plain = plain
        render_culled.last_eps = eps
        return out

    render_culled.proxy = proxy
    render_culled.last_active_frac = None
    render_culled.last_plain = None
    render_culled.last_eps = None
    return render_culled
