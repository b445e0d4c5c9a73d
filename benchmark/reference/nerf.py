"""The plain NeRF of Mildenhall et al. (ECCV 2020) in PyTorch: the reference
the benchmark holds the port's training steps and frames against.

It imports nothing of the port. Weights are a dict of torch-layout tensors
by name (`xyz_layers.<i>.weight` (out, in), `xyz_final`, `sigma`,
`dir_layer`, `rgb`), one dict a field, made here from a seed
(`random_field`, `ball_field`) and handed to both sides.

Every product of the fields takes its operands through `op`, which rounds
them, and on the way back their cotangents, to the precision the
configuration states (`bf16`: bfloat16 operands, float32 sums) or to the
one below it (`fp8`: e4m3 operands and e5m2 cotangents, each with a
per-tensor scale), the control. Sums are float32; the caller turns TF32
off.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

Weights = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8


# -- operand precision --------------------------------------------------------------

def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to float32; an 8-bit float takes a
    per-tensor scale that maps the largest magnitude to the type's largest."""
    if dtype == torch.bfloat16:
        return x.to(dtype).float()
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Round(torch.autograd.Function):
    """Operands rounded on the way forward, their cotangents on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _cast(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        return _cast(grad, ctx.bwd), None, None


# forward and backward types of each operand precision (fp8 as it trains:
# e4m3 forward, e5m2 cotangents)
PRECISIONS = {"bf16": (torch.bfloat16, torch.bfloat16),
              "fp8": (torch.float8_e4m3fn, torch.float8_e5m2)}


def operand_round(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    fwd, bwd = PRECISIONS[kind]
    return lambda x: _Round.apply(x, fwd, bwd)


# -- weights ----------------------------------------------------------------------

def emb_width(n_freqs: int) -> int:
    return 3 * (2 * n_freqs + 1)


def layer_shapes(cfg: dict) -> List[tuple]:
    """(name, out, in) of every linear layer of one field."""
    w, ex, ed = cfg["width"], emb_width(cfg["xyz_freqs"]), emb_width(cfg["dir_freqs"])
    out = []
    for i in range(cfg["depth"]):
        fan_in = ex if i == 0 else w + (ex if i in cfg["skips"] else 0)
        out.append((f"xyz_layers.{i}", w, fan_in))
    return out + [("xyz_final", w, w), ("sigma", 1, w),
                  ("dir_layer", cfg["dir_width"], w + ed), ("rgb", 3, cfg["dir_width"])]


def random_field(cfg: dict, generator: torch.Generator) -> Weights:
    """A field with PyTorch's default Linear init, U(-1/sqrt(in), 1/sqrt(in))
    for weights and biases, from one draw on the generator's device."""
    shapes = layer_shapes(cfg)
    total = sum(o * i + o for _, o, i in shapes)
    u = torch.rand(total, generator=generator, device=generator.device) * 2 - 1
    out, at = {}, 0
    for name, o, i in shapes:
        bound = 1.0 / math.sqrt(i)
        out[f"{name}.weight"] = (u[at:at + o * i] * bound).view(o, i)
        at += o * i
        out[f"{name}.bias"] = u[at:at + o] * bound
        at += o
    return out


def ball_field(cfg: dict, generator: torch.Generator, sigma: float = 15.0,
               radius: float = 0.6, rgb=(0.8, 0.35, 0.2), noise: float = 0.05) -> Weights:
    """A field whose density is a ball: sigma = `sigma` (1 - |x| / `radius`),
    zero outside it, colour about `rgb`, so a frame has empty space to cull
    and a surface to find. Layer 0 holds relu(+-n_j . x) for half-width
    quasi-uniform unit directions n_j (their |n_j . x| sum to ~ width |x| /
    4), the other trunk layers pass it on (identity; a skip layer's embedding
    columns are noise), the sigma head subtracts the sum from `sigma`. Every
    weight carries Gaussian noise of std `noise` / sqrt(fan-in), drawn on the
    generator's device in one call, so no product is trivial."""
    shapes = layer_shapes(cfg)
    total = sum(o * i for _, o, i in shapes)
    dev = generator.device
    z = torch.randn(total, generator=generator, device=dev)
    w, half, at = cfg["width"], cfg["width"] // 2, 0
    out: Weights = {}
    for name, o, i in shapes:
        out[f"{name}.weight"] = (z[at:at + o * i] * (noise / math.sqrt(i))).view(o, i)
        out[f"{name}.bias"] = torch.zeros(o, device=dev)
        at += o * i
    j = torch.arange(half, device=dev, dtype=torch.float64) + 0.5   # a Fibonacci sphere
    polar, azim = torch.arccos(1 - 2 * j / half), math.pi * (1 + 5 ** 0.5) * j
    n = torch.stack([torch.cos(azim) * torch.sin(polar), torch.sin(azim) * torch.sin(polar),
                     torch.cos(polar)], 1).float()
    out["xyz_layers.0.weight"][:half, :3] += n
    out["xyz_layers.0.weight"][half:, :3] -= n
    eye = torch.eye(w, device=dev)
    for k in range(1, cfg["depth"]):
        out[f"xyz_layers.{k}.weight"][:, -w:] += eye
    out["sigma.weight"] -= sigma / (radius * w / 4)
    out["sigma.bias"] += sigma
    out["dir_layer.bias"] += 1.0
    c = torch.tensor(rgb, device=dev)
    out["rgb.bias"] += torch.log(c / (1 - c))
    return out


# -- the field and the render -----------------------------------------------------

def embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(n-1) x), cos(2^(n-1) x)]."""
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, -1)


def dense(w: Weights, name: str, x: torch.Tensor, op) -> torch.Tensor:
    return op(x) @ op(w[f"{name}.weight"]).T + w[f"{name}.bias"]


def field(w: Weights, cfg: dict, xyz: torch.Tensor, dirs: Optional[torch.Tensor], op):
    """sigma (N,) of points xyz (N, 3); with unit directions `dirs` (N, 3)
    also rgb (N, 3)."""
    e = embed(xyz, cfg["xyz_freqs"])
    h = e
    for i in range(cfg["depth"]):
        if i in cfg["skips"]:
            h = torch.cat([e, h], -1)
        h = torch.relu(dense(w, f"xyz_layers.{i}", h, op))
    sigma = dense(w, "sigma", h, op)[:, 0]
    if dirs is None:
        return sigma, None
    feat = dense(w, "xyz_final", h, op)
    hd = torch.relu(dense(w, "dir_layer", torch.cat([feat, embed(dirs, cfg["dir_freqs"])], -1), op))
    return sigma, torch.sigmoid(dense(w, "rgb", hd, op))


def composite(sigma, z, dir_norm, rgb=None, noise=None, white_back=False):
    """Alpha compositing along each ray: weights, opacity (and rgb, depth)."""
    deltas = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1) * dir_norm
    if noise is not None:
        sigma = sigma + noise
    alpha = 1.0 - torch.exp(-deltas * torch.relu(sigma))
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    weights = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    out = {"weights": weights, "opacity": weights.sum(-1)}
    if rgb is not None:
        c = (weights[..., None] * rgb).sum(-2)
        out["rgb"] = c + (1.0 - out["opacity"][:, None]) if white_back else c
        out["depth"] = (weights * z).sum(-1)
    return out


def sample_pdf(bins, weights, n: int, u: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """Inverse-CDF samples of the piecewise-constant pdf `weights` over
    `bins`; evenly spaced u when `u` is None."""
    weights = weights + eps
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(cdf.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(weights.shape[1])
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def coarse_depths(rays, n: int, u: Optional[torch.Tensor] = None):
    near, far = rays[:, 6:7], rays[:, 7:8]
    t = torch.linspace(0.0, 1.0, n, device=rays.device)
    z = near * (1 - t) + far * t
    if u is not None:   # stratified: a uniform draw within each stratum
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        lo, hi = torch.cat([z[:, :1], mid], -1), torch.cat([mid, z[:, -1:]], -1)
        z = lo + (hi - lo) * u
    return z


def points(rays, z):
    return (rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]).reshape(-1, 3)


def render(wc: Weights, wf: Weights, cfg: dict, rays: torch.Tensor, op,
           draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Coarse + fine render of (R, 8) rays. With `draws` (training: strata,
    pdf and both sigma noises) both passes are full; without them it is the
    deterministic evaluation: a sigma-only coarse pass, evenly spaced pdf u."""
    r, s, n_imp = rays.shape[0], cfg["n_samples"], cfg["n_importance"]
    d = draws or {}
    dirs = rays[:, 3:6]
    dir_norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    z = coarse_depths(rays, s, d.get("strat_u"))
    train = draws is not None
    sig, rgb = field(wc, cfg, points(rays, z), dirs.repeat_interleave(s, 0) if train else None, op)
    comp_c = composite(sig.view(r, s), z, dir_norm, None if rgb is None else rgb.view(r, s, 3),
                       d.get("sigma_coarse"), cfg["white_back"])
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    z_f = sample_pdf(mid, comp_c["weights"][:, 1:-1].detach(), n_imp, d.get("pdf_u")).detach()
    z_all, _ = torch.sort(torch.cat([z, z_f], -1), -1)
    sa = s + n_imp
    sig, rgb = field(wf, cfg, points(rays, z_all), dirs.repeat_interleave(sa, 0), op)
    comp_f = composite(sig.view(r, sa), z_all, dir_norm, rgb.view(r, sa, 3),
                       d.get("sigma_fine"), cfg["white_back"])
    out = {"opacity_coarse": comp_c["opacity"], "rgb_fine": comp_f["rgb"],
           "depth_fine": comp_f["depth"], "opacity_fine": comp_f["opacity"]}
    if train:
        out["rgb_coarse"] = comp_c["rgb"]
    return out


# -- training ---------------------------------------------------------------------

def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The stream of one step's draws, a function of (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return g


def step_draws(seed: int, step: int, n_rays: int, cfg: dict, perturb: float,
               noise_std: float, device) -> Dict[str, torch.Tensor]:
    """A training step's draws in their order: the strata's uniforms, the
    coarse sigma noise, the pdf's uniforms, the fine sigma noise."""
    g = step_generator(seed, step, device)
    s, i = cfg["n_samples"], cfg["n_importance"]
    kw = dict(generator=g, device=device)
    draws = {}
    if perturb > 0:
        draws["strat_u"] = torch.rand(n_rays, s, **kw) * perturb
    if noise_std > 0:
        draws["sigma_coarse"] = torch.randn(n_rays, s, **kw) * noise_std
    if perturb != 0:
        draws["pdf_u"] = torch.rand(n_rays, i, **kw)
    if noise_std > 0:
        draws["sigma_fine"] = torch.randn(n_rays, s + i, **kw) * noise_std
    return draws


def train_steps(w0: Dict[str, Weights], cfg: dict, batches, seed: int, traffic: dict,
                op, moment_at: int, start: int = 0, block: int = 1024):
    """Steps of the coarse and fine fields under MSE (coarse + fine) and Adam
    at a constant learning rate, one a batch (rays (B, 8), rgbs (B, 3)), the
    rays taken `block` at a time, the first batch with the draws of global
    step `start`. Returns the loss of each step, Adam's first moment and
    the weights after step `moment_at`, and the weights after the last
    step, keyed '<field>.<name>'."""
    params = {f"{f}.{k}": v.detach().clone().requires_grad_(True)
              for f, ws in w0.items() for k, v in ws.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = traffic["lr"]
    losses, moment, mid = [], None, None
    for t, (rays, rgbs) in enumerate(batches, start=1):
        n = rays.shape[0]
        draws = step_draws(seed, start + t - 1, n, cfg, traffic["perturb"], traffic["noise_std"],
                           rays.device)
        fields = {f: {k: params[f"{f}.{k}"] for k in w0[f]} for f in w0}
        loss = 0.0
        for a in range(0, n, block):
            sl = slice(a, a + block)
            out = render(fields["coarse"], fields["fine"], cfg, rays[sl], op,
                         {k: v[sl] for k, v in draws.items()})
            part = (((out["rgb_coarse"] - rgbs[sl]) ** 2).sum()
                    + ((out["rgb_fine"] - rgbs[sl]) ** 2).sum()) / (n * 3)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            c1 = np.float32(1) - np.float32(B1) ** t
            c2 = np.float32(1) - np.float32(B2) ** t
            for k, p in params.items():
                g = p.grad
                mu[k].mul_(B1).add_(g, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                p.add_(-lr * (mu[k] / float(c1)) / ((nu[k] / float(c2)).sqrt() + EPS))
                p.grad = None
            if t == moment_at:
                moment = {k: v.clone() for k, v in mu.items()}
                mid = {k: p.detach().clone() for k, p in params.items()}
    return losses, moment, mid, {k: p.detach() for k, p in params.items()}
