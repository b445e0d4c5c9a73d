"""The StyleGAN2 generator as `nn.Module`s.

Counterpart of the generator half of `nerf_siren_tpu/models/stylegan2.py`
(reference: eg3d_training/networks_stylegan2.py):
- `FullyConnected`: weight ~ N(0, 1) / lr_multiplier, applied with the
  runtime gain lr_multiplier / sqrt(fan_in); bias x lr_multiplier;
- `modulated_conv2d` in the unfused form: scale the input by the styles,
  convolve, multiply by the demodulation coefficients, add noise;
- `MappingNetwork`: 2nd-moment normalisation, FCs at lr_multiplier 0.01,
  the `w_avg` buffer and truncation (`mapping_pre_broadcast` is the output
  before the ws broadcast);
- `SynthesisLayer` (modconv + const noise + lrelu bias_act at gain sqrt(2),
  flip_weight = (up == 1)), `ToRGB` (no demodulation, 1 / sqrt(fan_in)
  style gain), the skip-architecture `SynthesisBlock` and
  `SynthesisNetwork` (4 -> img_resolution, channels min(channel_base / res,
  channel_max)), `Generator`.
All float32 (the EG3D config uses no fp16 resolutions). Parameter and
buffer names follow the JAX tree (`convert.py` maps one to the other); the
resample filter is a non-persistent buffer. The discriminator,
`minibatch_stddev` and the `w_avg` EMA come with EG3D training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from nerf_siren_tpu_torch.ops.bias_act import activation_funcs, bias_act
from nerf_siren_tpu_torch.ops.conv2d_resample import conv2d_resample
from nerf_siren_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d

RESAMPLE_FILTER = [1, 3, 3, 1]


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt((x ** 2).mean(dim=dim, keepdim=True) + eps)


def _randn(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device)


class FullyConnected(nn.Module):
    """(reference networks_stylegan2.py:97-133)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 lr_multiplier: float = 1.0, bias_init: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(
            _randn((out_features, in_features), generator, device) / lr_multiplier)
        self.bias = (nn.Parameter(torch.full((out_features,), float(bias_init), device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor, activation: str = "linear") -> torch.Tensor:
        w = self.weight * (self.lr_multiplier / math.sqrt(self.weight.shape[1]))
        x = x @ w.T
        b = None if self.bias is None else self.bias * self.lr_multiplier
        if activation == "linear":
            return x if b is None else x + b
        return bias_act(x, b, dim=x.ndim - 1, act=activation)


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True):
    """x (N, I, H, W), weight (O, I, kh, kw), styles (N, I). The unfused
    execution (reference networks_stylegan2.py:71-79)."""
    dcoefs = None
    if demodulate:
        w = weight[None] * styles[:, None, :, None, None]                  # (N, O, I, kh, kw)
        dcoefs = torch.rsqrt((w ** 2).sum(dim=(2, 3, 4)) + 1e-8)           # (N, O)
    x = x * styles[:, :, None, None]
    x = conv2d_resample(x, weight, resample_filter, up=up, down=down, padding=padding,
                        flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs[:, :, None, None]
    if noise is not None:
        x = x + noise
    return x


# -- mapping ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MappingConfig:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    num_ws: int = 14
    num_layers: int = 8
    lr_multiplier: float = 0.01
    w_avg_beta: float = 0.998


class MappingNetwork(nn.Module):
    """(reference networks_stylegan2.py:193-271)."""

    def __init__(self, cfg: MappingConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        embed = cfg.w_dim if cfg.c_dim > 0 else 0
        features = [cfg.z_dim + embed] + [cfg.w_dim] * cfg.num_layers
        self.fcs = nn.ModuleList(
            FullyConnected(features[i], features[i + 1], lr_multiplier=cfg.lr_multiplier,
                           generator=generator, device=device)
            for i in range(cfg.num_layers))
        self.register_buffer("w_avg", torch.zeros(cfg.w_dim, device=device))
        self.embed = (FullyConnected(cfg.c_dim, embed, generator=generator, device=device)
                      if cfg.c_dim > 0 else None)

    def pre_broadcast(self, z: torch.Tensor, c: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The output before the ws broadcast and truncation: (N, w_dim)."""
        x = None
        if self.cfg.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.cfg.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for fc in self.fcs:
            x = fc(x, activation="lrelu")
        return x

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None) -> torch.Tensor:
        x = self.pre_broadcast(z, c)
        x = x[:, None, :].expand(x.shape[0], self.cfg.num_ws, self.cfg.w_dim)
        if truncation_psi != 1:
            w_avg = self.w_avg
            if truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (x[:, :truncation_cutoff] - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


# -- synthesis ------------------------------------------------------------------

def _noise(layer, noise_mode: str):
    if noise_mode == "const":
        return layer.noise_const * layer.noise_strength
    if noise_mode == "none":
        return None
    raise ValueError(f"noise_mode {noise_mode!r}: the port renders with 'const' or 'none' "
                     f"('random' comes with EG3D training)")


class SynthesisLayer(nn.Module):
    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3, up=1,
                 conv_clamp=None, *, generator=None, device=None):
        super().__init__()
        self.up, self.conv_clamp = up, conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator,
                                     device=device)
        self.weight = nn.Parameter(
            _randn((out_channels, in_channels, kernel_size, kernel_size), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        self.register_buffer("noise_const", _randn((resolution, resolution), generator, device))
        self.noise_strength = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x, w, resample_filter, noise_mode="const", gain=1.0):
        styles = self.affine(w)
        x = modulated_conv2d(x, self.weight, styles, noise=_noise(self, noise_mode), up=self.up,
                             padding=self.weight.shape[-1] // 2,
                             resample_filter=resample_filter, flip_weight=(self.up == 1))
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act="lrelu",
                        gain=activation_funcs["lrelu"].def_gain * gain, clamp=clamp)


class ToRGB(nn.Module):
    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1, conv_clamp=None, *,
                 generator=None, device=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, generator=generator,
                                     device=device)
        self.weight = nn.Parameter(
            _randn((out_channels, in_channels, kernel_size, kernel_size), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x, w):
        weight_gain = 1.0 / math.sqrt(self.weight.shape[1] * self.weight.shape[-1] ** 2)
        styles = self.affine(w) * weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    w_dim: int = 512
    img_resolution: int = 256
    img_channels: int = 96
    channel_base: int = 32768
    channel_max: int = 512
    conv_clamp: Optional[float] = None
    architecture: str = "skip"

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(2, int(math.log2(self.img_resolution)) + 1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def num_ws(self) -> int:
        return sum(1 if res == 4 else 2 for res in self.block_resolutions) + 1


class SynthesisBlock(nn.Module):
    def __init__(self, cfg: SynthesisConfig, res: int, *, generator=None, device=None):
        super().__init__()
        in_ch = cfg.channels(res // 2) if res > 4 else 0
        out_ch = cfg.channels(res)
        kw = dict(generator=generator, device=device)
        self.const = (nn.Parameter(_randn((out_ch, res, res), generator, device))
                      if in_ch == 0 else None)
        self.conv0 = (SynthesisLayer(in_ch, out_ch, cfg.w_dim, res, up=2,
                                     conv_clamp=cfg.conv_clamp, **kw) if in_ch else None)
        self.conv1 = SynthesisLayer(out_ch, out_ch, cfg.w_dim, res, conv_clamp=cfg.conv_clamp,
                                    **kw)
        self.torgb = (ToRGB(out_ch, cfg.img_channels, cfg.w_dim, conv_clamp=cfg.conv_clamp, **kw)
                      if cfg.architecture == "skip" or res == cfg.img_resolution else None)
        self.num_conv = 1 if in_ch == 0 else 2

    def forward(self, x, img, ws_block, resample_filter, noise_mode="const"):
        """ws_block: (B, num_conv + num_torgb, w_dim)."""
        w_iter = iter(ws_block.unbind(1))
        if self.const is not None:
            x = self.const[None].expand(ws_block.shape[0], *self.const.shape)
        else:
            x = self.conv0(x, next(w_iter), resample_filter, noise_mode)
        x = self.conv1(x, next(w_iter), resample_filter, noise_mode)
        if img is not None:
            img = upsample2d(img, resample_filter)
        if self.torgb is not None:
            y = self.torgb(x, next(w_iter))
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: SynthesisConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("resample_filter", setup_filter(RESAMPLE_FILTER, device=device),
                             persistent=False)
        for res in cfg.block_resolutions:
            self.add_module(f"b{res}", SynthesisBlock(cfg, res, generator=generator,
                                                      device=device))

    def forward(self, ws: torch.Tensor, noise_mode: str = "const") -> torch.Tensor:
        """ws (B, num_ws, w_dim) -> (B, img_channels, R, R)."""
        x = img = None
        w_idx = 0
        for res in self.cfg.block_resolutions:
            block = getattr(self, f"b{res}")
            n = block.num_conv + (block.torgb is not None)
            x, img = block(x, img, ws[:, w_idx: w_idx + n], self.resample_filter, noise_mode)
            w_idx += block.num_conv
        return img


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 256
    img_channels: int = 96
    mapping_layers: int = 8
    channel_base: int = 32768
    channel_max: int = 512
    conv_clamp: Optional[float] = None

    @property
    def synthesis(self) -> SynthesisConfig:
        return SynthesisConfig(self.w_dim, self.img_resolution, self.img_channels,
                               self.channel_base, self.channel_max, self.conv_clamp)

    @property
    def mapping(self) -> MappingConfig:
        return MappingConfig(self.z_dim, self.c_dim, self.w_dim,
                             num_ws=self.synthesis.num_ws, num_layers=self.mapping_layers)


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.mapping = MappingNetwork(cfg.mapping, generator=generator, device=device)
        self.synthesis = SynthesisNetwork(cfg.synthesis, generator=generator, device=device)

    def forward(self, z, c=None, truncation_psi: float = 1.0, noise_mode: str = "const"):
        return self.synthesis(self.mapping(z, c, truncation_psi=truncation_psi),
                              noise_mode=noise_mode)
