"""Volume rendering core.

Counterpart of `nerf_siren_tpu/render/rendering.py`: stratified sampling
linear in depth or disparity, optional perturbation and sigma noise, alpha
compositing with the cumprod transmittance recurrence (last delta 1e10,
``+1e-10`` inside the product), white background, the test-time sigma-only
coarse pass, and hierarchical `sample_pdf` on the interval midpoints with
the two edge weights dropped. Random draws come from an explicit
`torch.Generator`; without one the render is deterministic. A training
step may instead hand `render_rays` its draws made beforehand (a
`StepNoise` from `draw_noise`: the same generator calls in the same order
at the same shapes, so the render is bit-equal), which a captured CUDA
graph needs: it cannot make a generator per step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from nerf_siren_tpu_torch.config import RenderConfig
from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf

# One render's random draws by name: 'strat_u' (R, n_samples) uniform,
# 'sigma_coarse' (R, n_samples) and 'sigma_fine' (R, n_samples +
# n_importance) standard normal, 'pdf_u' (R, n_importance) uniform; for the
# culled render (`render/culled_train.py`) 'culled_pdf_u' (R, n_sel) and
# 'culled_strat_u' (R, n_uni) uniform, 'culled_sigma_coarse' and
# 'culled_sigma_fine' (R, n_sel + n_uni) standard normal; only those the
# config draws (`noise_shapes`).
StepNoise = Dict[str, torch.Tensor]


def noise_shapes(n_rays: int, cfg: RenderConfig,
                 culled: Optional[Tuple[int, int]] = None) -> Dict[str, tuple]:
    """name -> (shape, `torch.rand` or `torch.randn`) of the draws
    `render_rays` makes from a generator under `cfg`, in its order; with
    `culled` (n_sel, n_uni) those of `render_rays_culled` instead (JAX's
    four keys: the pdf's u where perturb != 0, the strata's where perturb >
    0, the coarse and the fine density noise)."""
    spec = {}
    if culled is not None:
        n_sel, n_uni = culled
        if cfg.perturb != 0.0:
            spec["culled_pdf_u"] = ((n_rays, n_sel), torch.rand)
        if cfg.perturb > 0.0:
            spec["culled_strat_u"] = ((n_rays, n_uni), torch.rand)
        if cfg.noise_std > 0.0:
            spec["culled_sigma_coarse"] = ((n_rays, n_sel + n_uni), torch.randn)
            spec["culled_sigma_fine"] = ((n_rays, n_sel + n_uni), torch.randn)
        return spec
    s, i = cfg.n_samples, cfg.n_importance
    if cfg.perturb > 0.0:
        spec["strat_u"] = ((n_rays, s), torch.rand)
    if cfg.noise_std > 0.0:
        spec["sigma_coarse"] = ((n_rays, s), torch.randn)
    if i > 0 and cfg.perturb != 0.0:
        spec["pdf_u"] = ((n_rays, i), torch.rand)
    if i > 0 and cfg.noise_std > 0.0:
        spec["sigma_fine"] = ((n_rays, s + i), torch.randn)
    return spec


def draw_noise(generator: torch.Generator, n_rays: int, cfg: RenderConfig,
               culled: Optional[Tuple[int, int]] = None) -> StepNoise:
    """The draws `render_rays(..., generator)` (with `culled`,
    `render_rays_culled`) makes for `n_rays` float32 rays under `cfg`, made
    now, from `generator` (on its device)."""
    return {name: fn(shape, generator=generator, dtype=torch.float32,
                     device=generator.device)
            for name, (shape, fn) in noise_shapes(n_rays, cfg, culled).items()}


class _Transmittance(torch.autograd.Function):
    """`torch.cumprod` along the last axis, with cumprod's own backward for
    an input without zeros (the reversed cumulative sum of output * grad,
    over the input) but not its check for zeros, which reads a flag on the
    host and so cannot be captured into a CUDA graph. The factors here,
    1 - alpha + 1e-10 with alpha in [0, 1], are never zero."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        return (y * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def composite(
    sigmas: torch.Tensor,
    z_vals: torch.Tensor,
    dir_norm: torch.Tensor,
    rgbs: Optional[torch.Tensor] = None,
    *,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    white_back: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Alpha-composite raw sigma (R, S) (and rgb (R, S, 3)) along each ray.
    The sigma noise is drawn from `generator`, or is `noise` (R, S), standard
    normal, drawn beforehand.

    Returns 'weights' (R, S), 'opacity' (R,), and with `rgbs` also
    'rgb' (R, 3) and 'depth' (R,).
    """
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    delta_inf = torch.full_like(deltas[:, :1], 1e10)
    deltas = torch.cat([deltas, delta_inf], dim=-1) * dir_norm

    if noise_std > 0.0 and generator is not None:
        noise = torch.randn(sigmas.shape, generator=generator, dtype=sigmas.dtype,
                            device=sigmas.device)
    if noise_std > 0.0 and noise is not None:
        sigmas = sigmas + noise * noise_std

    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    trans = _Transmittance.apply(1.0 - alphas + 1e-10)
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
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Coarse depths (R, n_samples) between near/far (R, 1), linear in depth
    or disparity, jittered within strata when `perturb` > 0 by uniform draws
    from `generator`, or by `u` (R, n_samples) drawn beforehand."""
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)

    if perturb > 0.0 and generator is not None:
        u = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                       device=z_vals.device)
    if perturb > 0.0 and u is not None:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
        z_vals = lower + (upper - lower) * (perturb * u)
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
    field_fn: Optional[Callable] = None,
    noise: Optional[StepNoise] = None,
    cls_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """Render (R, 8) rays = [origin(3), direction(3), near, far].

    `models` holds 'coarse' and (with n_importance > 0) 'fine' `NeRF`s,
    whose configs fix the encodings' frequencies. Returns
    rgb/depth/opacity_{coarse,fine} (+ cls_* with a semantic head);
    `test_time` drops the coarse rgb pass and keeps only opacity_coarse.
    `field_fn` overrides the field evaluation, with the signature
    (model, xyz (R, S, 3), dir_emb (R, Cd) or None) -> raw (R, S, 1) sigma
    or (R, S, 4+) [rgb, sigma(, cls)]; the `fused` training backend passes
    one backed by K2. The fine depths are detached: only the fields'
    parameters get gradients through the sample positions' values.
    `noise` (from `draw_noise`) takes the place of `generator`.
    `cls_fn` (xyz (R, S, 3), rgb (R, S, 3), weights (R, S)) -> (R, C) gives
    each rgb pass its cls_* output instead of the field's semantic head
    (`render.rendering_3d` passes the point network's).
    """
    if noise is not None:
        want = noise_shapes(rays.shape[0], cfg)
        if generator is not None or {k: tuple(v.shape) for k, v in noise.items()} != \
                {k: shape for k, (shape, _) in want.items()}:
            raise ValueError(f"noise: expected the draws {list(want)} at their shapes "
                             "(`draw_noise`) and no generator")
    else:
        noise = {}
    if field_fn is None:
        def field_fn(model, xyz, d_emb):
            return _field(model, xyz, d_emb, compute_dtype)

    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    dir_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dir_emb = positional_encoding(rays_d, _n_freqs(models["coarse"].cfg.in_channels_dir))

    z_vals = stratified_z_vals(near, far, cfg.n_samples, use_disp=cfg.use_disp,
                               perturb=cfg.perturb, generator=generator,
                               u=noise.get("strat_u"))
    xyz_coarse = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]

    result: Dict[str, torch.Tensor] = {}
    if cfg.test_time:
        sigmas = field_fn(models["coarse"], xyz_coarse, None)[..., 0]
        comp = composite(sigmas, z_vals, dir_norm, noise_std=cfg.noise_std,
                         generator=generator, noise=noise.get("sigma_coarse"))
        result["opacity_coarse"] = comp["opacity"]
    else:
        raw = field_fn(models["coarse"], xyz_coarse, dir_emb)
        comp = composite(raw[..., 3], z_vals, dir_norm, raw[..., :3],
                         noise_std=cfg.noise_std, generator=generator,
                         white_back=cfg.white_back, noise=noise.get("sigma_coarse"))
        result["rgb_coarse"] = comp["rgb"]
        result["depth_coarse"] = comp["depth"]
        result["opacity_coarse"] = comp["opacity"]
        if cls_fn is not None:
            result["cls_coarse"] = cls_fn(xyz_coarse, raw[..., :3], comp["weights"])
        elif raw.shape[-1] > 4:
            result["cls_coarse"] = (comp["weights"][..., None] * raw[..., 4:]).sum(dim=-2)
    weights_coarse = comp["weights"]

    if cfg.n_importance > 0:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        z_fine = sample_pdf(z_mid, weights_coarse[:, 1:-1], cfg.n_importance,
                            generator=generator, det=(cfg.perturb == 0.0),
                            u=noise.get("pdf_u")).detach()
        z_all, _ = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)
        xyz_fine = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]

        raw = field_fn(models["fine"], xyz_fine, dir_emb)
        comp = composite(raw[..., 3], z_all, dir_norm, raw[..., :3],
                         noise_std=cfg.noise_std, generator=generator,
                         white_back=cfg.white_back, noise=noise.get("sigma_fine"))
        result["rgb_fine"] = comp["rgb"]
        result["depth_fine"] = comp["depth"]
        result["opacity_fine"] = comp["opacity"]
        if cls_fn is not None:
            result["cls_fine"] = cls_fn(xyz_fine, raw[..., :3], comp["weights"])
        elif raw.shape[-1] > 4:
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
