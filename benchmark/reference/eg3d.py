"""EG3D's generator (Chan et al., CVPR 2022; github.com/NVlabs/eg3d) as the
reference fork trains it on one scene: a learnable latent z, the StyleGAN2
mapping and synthesis (4x4 to the plane resolution, skip architecture,
`channel_base` / `channel_max` channels) whose image is three feature
planes, the OSG decoder and the importance renderer. Plain PyTorch; it
imports nothing of the port.

Weights are one dict of tensors by name, the port's state_dict names (the
NVlabs module tree): `z`, `backbone.mapping.fcs.<i>.{weight,bias}`,
`backbone.mapping.w_avg`, `backbone.synthesis.b<res>.{const, conv0.*,
conv1.*, torgb.*}` (a layer's `affine.{weight,bias}`, `weight`, `bias`,
`noise_const`, `noise_strength`), `decoder.fc{1,2}.{weight,bias}`. The
benchmark makes them from a seed (`random_weights`) and hands the same to
both sides. Everything is float32, and the caller turns TF32 off; `op`
(`Operands`) rounds the operands of each kind of product, and on the way
back their cotangents, to the precision the configuration states (PyTorch's
defaults, as the port's training CLI runs: the synthesis convolutions in
TF32, the fully connected layers and the decoder in float32) or to the one
below it, the control (the convolutions in bfloat16, the rest in TF32).
The FIR filters' depthwise convolutions stay float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8
SQRT2 = math.sqrt(2.0)
FIR = (1.0, 3.0, 3.0, 1.0)


def block_resolutions(cfg: dict):
    return [2 ** i for i in range(2, int(math.log2(cfg["plane_resolution"])) + 1)]


def channels(cfg: dict, res: int) -> int:
    return min(cfg["channel_base"] // res, cfg["channel_max"])


def weight_specs(cfg: dict):
    """(name, shape, init) of every tensor: 'randn' N(0, 1) (the mapping's
    weights N(0, 1) / 0.01), or a constant."""
    w_dim, img_ch = cfg["w_dim"], 3 * cfg["plane_channels"]
    specs = [("z", (1, cfg["z_dim"]), "randn")]
    feats = [cfg["z_dim"]] + [w_dim] * cfg["mapping_layers"]
    for i in range(cfg["mapping_layers"]):
        specs += [(f"backbone.mapping.fcs.{i}.weight", (feats[i + 1], feats[i]), "randn_lr"),
                  (f"backbone.mapping.fcs.{i}.bias", (feats[i + 1],), 0.0)]
    specs.append(("backbone.mapping.w_avg", (w_dim,), 0.0))
    for res in block_resolutions(cfg):
        out_ch, pre = channels(cfg, res), f"backbone.synthesis.b{res}"
        in_ch = channels(cfg, res // 2) if res > 4 else 0
        if res == 4:
            specs.append((f"{pre}.const", (out_ch, res, res), "randn"))
        for conv, cin in (("conv0", in_ch), ("conv1", out_ch)):
            if cin == 0:
                continue
            specs += [(f"{pre}.{conv}.affine.weight", (cin, w_dim), "randn"),
                      (f"{pre}.{conv}.affine.bias", (cin,), 1.0),
                      (f"{pre}.{conv}.weight", (out_ch, cin, 3, 3), "randn"),
                      (f"{pre}.{conv}.bias", (out_ch,), 0.0),
                      (f"{pre}.{conv}.noise_const", (res, res), "randn"),
                      (f"{pre}.{conv}.noise_strength", (), 0.0)]
        specs += [(f"{pre}.torgb.affine.weight", (out_ch, w_dim), "randn"),
                  (f"{pre}.torgb.affine.bias", (out_ch,), 1.0),
                  (f"{pre}.torgb.weight", (img_ch, out_ch, 1, 1), "randn"),
                  (f"{pre}.torgb.bias", (img_ch,), 0.0)]
    hid, c = cfg["decoder_hidden"], cfg["plane_channels"]
    specs += [("decoder.fc1.weight", (hid, c), "randn"), ("decoder.fc1.bias", (hid,), 0.0),
              ("decoder.fc2.weight", (cfg["decoder_out"], hid), "randn"),
              ("decoder.fc2.bias", (cfg["decoder_out"],), 0.0)]
    return specs


def random_weights(cfg: dict, generator: torch.Generator) -> Weights:
    """Every tensor at its init, the normal ones from one draw on the
    generator's device."""
    specs = weight_specs(cfg)
    dev = generator.device
    total = sum(math.prod(s) for _, s, init in specs if isinstance(init, str))
    z = torch.randn(total, generator=generator, device=dev)
    out, at = {}, 0
    for name, shape, init in specs:
        if isinstance(init, str):
            n = math.prod(shape)
            out[name] = z[at:at + n].view(shape) / (0.01 if init == "randn_lr" else 1.0)
            at += n
        else:
            out[name] = torch.full(shape, float(init), device=dev)
    return out


# -- StyleGAN2 ----------------------------------------------------------------------

def fc(p: Weights, name: str, x, lr_mult: float = 1.0, lrelu: bool = False, op=None):
    w = p[f"{name}.weight"]
    w = w * (lr_mult / math.sqrt(w.shape[1]))
    y = (x @ w.T if op is None else op.mm(x) @ op.mm(w).T) + p[f"{name}.bias"] * lr_mult
    return F.leaky_relu(y, 0.2) * SQRT2 if lrelu else y


def mapping(p: Weights, cfg: dict, z: torch.Tensor, op=None) -> torch.Tensor:
    """The mapping's output before its broadcast to the ws: (1, w_dim)."""
    x = z * torch.rsqrt((z ** 2).mean(-1, keepdim=True) + 1e-8)
    for i in range(cfg["mapping_layers"]):
        x = fc(p, f"backbone.mapping.fcs.{i}", x, 0.01, lrelu=True, op=op)
    return x


def fir_filter(device) -> torch.Tensor:
    f = torch.tensor(FIR, device=device)
    f = torch.outer(f, f)
    return f / f.sum()


def upfirdn(x, f, up: int, pad):
    """Zero-stuff by `up`, pad (x0, x1, y0, y1), filter with the (flipped,
    here symmetric) FIR times up^2."""
    n, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, list(pad))
    k = (f * up * up).flip([0, 1])
    return F.conv2d(x, k[None, None].expand(c, 1, *k.shape), groups=c)


def modconv(x, weight, styles, demod: bool, up: int, f, op):
    """Modulated convolution, unfused: scale the input by the styles,
    convolve (up: zero-stuff, FIR, then a true convolution), demodulate."""
    if demod:
        dco = torch.rsqrt(((weight[None] * styles[:, None, :, None, None]) ** 2)
                          .sum((2, 3, 4)) + 1e-8)
    x = x * styles[:, :, None, None]
    k = weight.shape[-1]
    if up > 1:
        p = k // 2
        fw = f.shape[-1]
        x = upfirdn(x, f, up, (p + (fw + up - 1) // 2, p + (fw - up) // 2,
                               p + (fw + up - 1) // 2, p + (fw - up) // 2))
        x = F.conv2d(op.conv(x), op.conv(weight.flip([-2, -1])))
    else:
        x = F.conv2d(op.conv(x), op.conv(weight), padding=k // 2)
    return x * dco[:, :, None, None] if demod else x


def synth_layer(p, pre, x, w, up, f, op):
    styles = fc(p, f"{pre}.affine", w, op=op)
    x = modconv(x, p[f"{pre}.weight"], styles, True, up, f, op)
    x = x + p[f"{pre}.noise_const"] * p[f"{pre}.noise_strength"]
    return F.leaky_relu(x + p[f"{pre}.bias"][None, :, None, None], 0.2) * SQRT2


def synthesis(p: Weights, cfg: dict, w: torch.Tensor, op) -> torch.Tensor:
    """w (1, w_dim), broadcast to every layer -> the planes (1, 3, C, R, R)."""
    f = fir_filter(w.device)
    x = img = None
    for res in block_resolutions(cfg):
        pre = f"backbone.synthesis.b{res}"
        if res == 4:
            x = p[f"{pre}.const"][None]
        else:
            x = synth_layer(p, f"{pre}.conv0", x, w, 2, f, op)
        x = synth_layer(p, f"{pre}.conv1", x, w, 1, f, op)
        if img is not None:
            img = upfirdn(img, f, 2, (2, 1, 2, 1))
        tw = p[f"{pre}.torgb.weight"]
        styles = fc(p, f"{pre}.torgb.affine", w, op=op) / math.sqrt(tw.shape[1])
        y = modconv(x, tw, styles, False, 1, f, op) + p[f"{pre}.torgb.bias"][None, :, None, None]
        img = y if img is None else img + y
    r = img.shape[-1]
    return img.reshape(1, 3, cfg["plane_channels"], r, r)


# -- the triplane renderer ------------------------------------------------------------

def sample_planes(planes: torch.Tensor, xyz: torch.Tensor, box_warp: float) -> torch.Tensor:
    """Bilinear, zero-padded samples (align_corners False) of the three
    planes at points (M, 3), each plane on its two world axes (xy, xz, zx):
    (3, M, C)."""
    q = xyz * (2.0 / box_warp)
    uv = torch.stack([q[:, [0, 1]], q[:, [0, 2]], q[:, [2, 0]]])          # (3, M, 2)
    out = F.grid_sample(planes[0], uv[:, None], mode="bilinear", padding_mode="zeros",
                        align_corners=False)                              # (3, C, 1, M)
    return out[:, :, 0].transpose(1, 2)


def decoder(p: Weights, feats: torch.Tensor, op):
    x = feats.mean(0)
    x = fc(p, "decoder.fc2", F.softplus(fc(p, "decoder.fc1", x, op=op)), op=op)
    return torch.sigmoid(x[:, 1:]) * (1 + 2 * 0.001) - 0.001, x[:, 0]


def march(colors, sigmas, depths, white_back: bool):
    """Midpoint quadrature: colors (R, S, 3), sigmas, depths (R, S) ->
    rgb (R, 3), depth (R,), weights (R, S - 1)."""
    deltas = depths[:, 1:] - depths[:, :-1]
    c_mid = 0.5 * (colors[:, :-1] + colors[:, 1:])
    s_mid = F.softplus(0.5 * (sigmas[:, :-1] + sigmas[:, 1:]) - 1.0)
    d_mid = 0.5 * (depths[:, :-1] + depths[:, 1:])
    alpha = 1.0 - torch.exp(-s_mid * deltas)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1 - alpha + 1e-10], -1), -1)
    weights = alpha * trans[:, :-1]
    rgb = (weights[..., None] * c_mid).sum(1)
    total = weights.sum(1)
    depth = torch.nan_to_num((weights * d_mid).sum(1) / total, nan=float("inf"))
    depth = torch.clamp(depth, depths.min(), depths.max())
    if white_back:
        rgb = rgb + 1 - total[:, None]
    return rgb, depth, weights


def sample_pdf(bins, weights, n: int, u, eps: float = 1e-5):
    weights = weights + eps
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(weights.shape[1])
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def render(p: Weights, cfg: dict, rays: torch.Tensor, draws: Dict[str, torch.Tensor], op):
    """A training render of (R, >= 6) rays: the planes of z, stratified
    coarse depths between ray_start and ray_end, the coarse march, the
    pooled weights + 0.01 resampled (`pdf_u`), the depth-sorted union, the
    fine march. Returns (rgb_coarse, rgb_fine, the mapping's output)."""
    w = mapping(p, cfg, p["z"], op)
    planes = synthesis(p, cfg, w, op)
    o, d = rays[:, 0:3], rays[:, 3:6]
    r, s, n_imp = rays.shape[0], cfg["n_samples"], cfg["n_importance"]
    lo, hi = cfg["ray_start"], cfg["ray_end"]
    t = torch.linspace(lo, hi, s, device=rays.device)[None].expand(r, s)
    z_c = t + draws["strat_u"][0] * ((hi - lo) / (s - 1))

    def field(z):
        feats = sample_planes(planes, (o[:, None] + z[..., None] * d[:, None]).reshape(-1, 3),
                              cfg["box_warp"])
        rgb, sigma = decoder(p, feats, op)
        return rgb.view(r, -1, 3), sigma.view(r, -1)

    c_c, s_c = field(z_c)
    rgb_c, _, w_c = march(c_c, s_c, z_c, cfg["white_back"])
    wp = F.pad(w_c, [1, 1], value=float("-inf"))
    wp = torch.maximum(wp[:, :-1], wp[:, 1:])
    wp = 0.5 * (wp[:, :-1] + wp[:, 1:]) + 0.01
    z_f = sample_pdf(0.5 * (z_c[:, :-1] + z_c[:, 1:]), wp[:, 1:-1], n_imp,
                     draws["pdf_u"]).detach()
    c_f, s_f = field(z_f)
    z_all, order = torch.sort(torch.cat([z_c, z_f], 1), dim=1, stable=True)
    c_all = torch.cat([c_c, c_f], 1).gather(1, order[..., None].expand(r, s + n_imp, 3))
    s_all = torch.cat([s_c, s_f], 1).gather(1, order)
    rgb_f, _, _ = march(c_all, s_all, z_all, cfg["white_back"])
    return rgb_c, rgb_f, w


def step_draws(seed: int, step: int, n_rays: int, cfg: dict, device):
    """A step's draws in their order: the strata's uniforms (1, R, S), the
    pdf's (R, I)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return {"strat_u": torch.rand(1, n_rays, cfg["n_samples"], generator=g, device=device),
            "pdf_u": torch.rand(n_rays, cfg["n_importance"], generator=g, device=device)}


def train_steps(w0: Weights, cfg: dict, batches, seed: int, traffic: dict, op,
                moment_at: int, start: int = 0, block: Optional[int] = None):
    """Steps under MSE (coarse + fine) and Adam at a constant learning rate
    over every tensor, then the `w_avg` EMA from the step's mapping output,
    one step a batch, the first with the draws of global step `start`.
    Returns each step's loss, Adam's first moment and the tensors after step
    `moment_at`, and the tensors after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, beta = traffic["lr"], cfg["w_avg_beta"]
    losses, moment, mid = [], None, None
    for t, (rays, rgbs) in enumerate(batches, start=1):
        draws = step_draws(seed, start + t - 1, rays.shape[0], cfg, rays.device)
        rgb_c, rgb_f, w = render(params, cfg, rays, draws, op)
        loss = ((rgb_c - rgbs) ** 2).mean() + ((rgb_f - rgbs) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), grads)}
            c1 = float(np.float32(1) - np.float32(B1) ** t)
            c2 = float(np.float32(1) - np.float32(B2) ** t)
            for k, p in params.items():
                mu[k].mul_(B1).add_(grads[k], alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(grads[k], grads[k], value=1 - B2)
                p.add_(-lr * (mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS))
            w_avg = params["backbone.mapping.w_avg"]
            mean = w.detach().mean(0)
            w_avg.copy_(mean + beta * (w_avg - mean))
            if t == moment_at:
                moment = {k: v.clone() for k, v in mu.items()}
                mid = {k: p.detach().clone() for k, p in params.items()}
    return losses, moment, mid, {k: p.detach() for k, p in params.items()}


Round = Callable[[torch.Tensor], torch.Tensor]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its float32 mantissa rounded to TF32's 10 bits (to nearest,
    ties away from zero), as the tensor cores take it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class _Round(torch.autograd.Function):
    """Operands rounded on the way forward, their cotangents on the way back."""

    @staticmethod
    def forward(ctx, x, rounding):
        ctx.rounding = rounding
        return rounding(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.rounding(grad), None


def _rounded(rounding) -> Round:
    if rounding is None:
        return lambda x: x
    return lambda x: _Round.apply(x, rounding)


@dataclasses.dataclass(frozen=True)
class Operands:
    """How each kind of product takes its operands: `mm` the fully connected
    layers (mapping, affines, decoder), `conv` the modulated convolutions."""
    mm: Round
    conv: Round


# (fully connected, convolutions) of each precision a configuration names
PRECISIONS = {"tf32_conv": (None, _tf32), "bf16_conv": (_tf32, _bf16), "f32": (None, None)}


def operand_round(kind: str) -> Operands:
    """tf32_conv: PyTorch's defaults on a card (cuDNN's convolutions in TF32,
    matmuls in float32), the configuration's; bf16_conv: the convolutions in
    bfloat16 and the matmuls in TF32, one precision below each, the control;
    f32: float32 throughout, as the port runs on a CPU."""
    mm, conv = PRECISIONS[kind]
    return Operands(_rounded(mm), _rounded(conv))
