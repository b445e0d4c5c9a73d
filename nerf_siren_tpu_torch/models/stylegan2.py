"""The StyleGAN2 generator as `nn.Module`s.

Counterpart of the generator half of `nerf_siren_tpu/models/stylegan2.py`
(reference: eg3d_training/networks_stylegan2.py):
- `FullyConnected`: weight ~ N(0, 1) / lr_multiplier, applied with the
  runtime gain lr_multiplier / sqrt(fan_in); bias x lr_multiplier;
- `modulated_conv2d` in the unfused form: scale the input by the styles,
  convolve, multiply by the demodulation coefficients, add noise;
- `MappingNetwork`: 2nd-moment normalisation, FCs at lr_multiplier 0.01,
  the `w_avg` buffer and truncation (`pre_broadcast` is the output before
  the ws broadcast), and `w_avg_ema`, the buffer's training update;
- `SynthesisLayer` (modconv + noise + lrelu bias_act at gain sqrt(2),
  flip_weight = (up == 1)), `ToRGB` (no demodulation, 1 / sqrt(fan_in)
  style gain), the skip-architecture `SynthesisBlock` and
  `SynthesisNetwork` (4 -> img_resolution, channels min(channel_base / res,
  channel_max)), `Generator`. Noise is 'const' (the layer's `noise_const`),
  'none', or 'random': (B, 1, res, res) standard normal draws per layer,
  taken from a `torch.Generator` or pre-drawn (`noise_shapes`);
- `Conv2dLayer`, `minibatch_stddev` and the resnet `Discriminator`, which
  the JAX package keeps beside the generator and no training calls.
All float32 (the EG3D config uses no fp16 resolutions). Parameter and
buffer names follow the JAX tree (`convert.py` maps one to the other); the
resample filter is a non-persistent buffer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

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

    def w_avg_ema(self, w_pre_broadcast: torch.Tensor) -> torch.Tensor:
        """The `w_avg` buffer after one training step: mean + beta (w_avg -
        mean), the mean over the batch of the (detached) mapping output
        before the broadcast (reference networks_stylegan2.py:251-254)."""
        mean = w_pre_broadcast.detach().mean(dim=0)
        return mean + self.cfg.w_avg_beta * (self.w_avg - mean)

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

NOISE_MODES = ("const", "random", "none")


def _noise(layer, noise_mode: str, draw: Optional[torch.Tensor]):
    """The layer's noise term: const x strength, a (B, 1, res, res) standard
    normal `draw` x strength ('random'), or None."""
    if noise_mode == "const":
        return layer.noise_const * layer.noise_strength
    if noise_mode == "none":
        return None
    if noise_mode != "random":
        raise ValueError(f"noise_mode {noise_mode!r}: one of {NOISE_MODES}")
    if draw is None:
        raise ValueError("noise_mode 'random' needs a generator or pre-drawn noise")
    return draw * layer.noise_strength


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

    def forward(self, x, w, resample_filter, noise_mode="const", gain=1.0, noise=None):
        """noise: this layer's (B, 1, res, res) standard normal draw ('random')."""
        styles = self.affine(w)
        x = modulated_conv2d(x, self.weight, styles, noise=_noise(self, noise_mode, noise),
                             up=self.up,
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

    def forward(self, x, img, ws_block, resample_filter, noise_mode="const", noise=None):
        """ws_block: (B, num_conv + num_torgb, w_dim); noise: the block's
        draws by layer name ('conv0', 'conv1'), for 'random'."""
        noise = noise or {}
        w_iter = iter(ws_block.unbind(1))
        if self.const is not None:
            x = self.const[None].expand(ws_block.shape[0], *self.const.shape)
        else:
            x = self.conv0(x, next(w_iter), resample_filter, noise_mode, noise=noise.get("conv0"))
        x = self.conv1(x, next(w_iter), resample_filter, noise_mode, noise=noise.get("conv1"))
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

    def noise_shapes(self, batch: int) -> Dict[str, Tuple[int, ...]]:
        """'b<res>.conv<i>' -> (batch, 1, res, res): the draws of noise_mode
        'random', in the order the layers run (the JAX key split's order:
        one key per block, split in two for its conv0 and conv1)."""
        shapes = {}
        for res in self.cfg.block_resolutions:
            for name in (("conv1",) if res == 4 else ("conv0", "conv1")):
                shapes[f"b{res}.{name}"] = (batch, 1, res, res)
        return shapes

    def draw_noise(self, generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
        """Standard normal draws of `noise_shapes`, from `generator` in order."""
        return {k: torch.randn(shape, generator=generator, device=generator.device)
                for k, shape in self.noise_shapes(batch).items()}

    def forward(self, ws: torch.Tensor, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """ws (B, num_ws, w_dim) -> (B, img_channels, R, R). noise_mode
        'random' takes its draws from `noise` (`noise_shapes`) or, without
        it, from `generator`."""
        if noise_mode == "random" and noise is None and generator is not None:
            noise = self.draw_noise(generator, ws.shape[0])
        x = img = None
        w_idx = 0
        for res in self.cfg.block_resolutions:
            block = getattr(self, f"b{res}")
            n = block.num_conv + (block.torgb is not None)
            block_noise = {k.split(".")[1]: v for k, v in (noise or {}).items()
                           if k.split(".")[0] == f"b{res}"}
            x, img = block(x, img, ws[:, w_idx: w_idx + n], self.resample_filter, noise_mode,
                           block_noise)
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

    def forward(self, z, c=None, truncation_psi: float = 1.0, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, torch.Tensor]] = None):
        return self.synthesis(self.mapping(z, c, truncation_psi=truncation_psi),
                              noise_mode=noise_mode, generator=generator, noise=noise)


# -- discriminator (reference networks_stylegan2.py:557-795; the JAX package
# keeps it beside the generator, and no training calls it) ----------------------

class Conv2dLayer(nn.Module):
    """A plain convolution, weight N(0, 1) applied with the runtime gain
    1 / sqrt(fan_in), optional up/down resampling and bias_act (JAX
    `apply_conv2d_layer`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True, *, generator=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            _randn((out_channels, in_channels, kernel_size, kernel_size), generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if bias else None

    def forward(self, x, f=None, up=1, down=1, activation="linear", gain=1.0,
                conv_clamp=None):
        w = self.weight
        k = w.shape[-1]
        x = conv2d_resample(x, w * (1.0 / math.sqrt(w.shape[1] * k ** 2)), f, up=up, down=down,
                            padding=k // 2, flip_weight=(up == 1))
        clamp = conv_clamp * gain if conv_clamp is not None else None
        return bias_act(x, self.bias, act=activation,
                        gain=activation_funcs[activation].def_gain * gain, clamp=clamp)


def minibatch_stddev(x: torch.Tensor, group_size: Optional[int] = 4,
                     num_channels: int = 1) -> torch.Tensor:
    """(reference networks_stylegan2.py:682-703 MinibatchStdLayer), as the
    JAX package computes it: groups of g = n // (n // min(group_size, n))
    samples taken with stride n // g, each output repeated g times in a
    row."""
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    g = max(1, n // max(1, n // g))
    f = num_channels
    y = x.reshape(g, -1, f, c // f, h, w)
    y = y - y.mean(dim=0)
    y = torch.sqrt((y ** 2).mean(dim=0) + 1e-8)
    y = y.mean(dim=(2, 3, 4))                                   # (n // g, F)
    y = y.repeat_interleave(g, dim=0).reshape(n, f, 1, 1).expand(n, f, h, w)
    return torch.cat([x, y], dim=1)


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    c_dim: int = 0
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1

    @property
    def block_resolutions(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(int(math.log2(self.img_resolution)), 2, -1))

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)


class DiscriminatorBlock(nn.Module):
    """conv0 (3x3), conv1 (3x3, down 2) and the 1x1 skip (down 2, no bias)."""

    def __init__(self, in_channels: int, out_channels: int, *, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.conv0 = Conv2dLayer(in_channels, in_channels, **kw)
        self.conv1 = Conv2dLayer(in_channels, out_channels, **kw)
        self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1, bias=False, **kw)

    def forward(self, x, f):
        y = self.skip(x, f=f, down=2, gain=math.sqrt(0.5))
        x = self.conv0(x, activation="lrelu")
        x = self.conv1(x, f=f, down=2, activation="lrelu", gain=math.sqrt(0.5))
        return y + x


class Discriminator(nn.Module):
    """The resnet discriminator: `frgb` (1x1), blocks b<res> from
    img_resolution down to 8, minibatch stddev, `epi_conv`, `epi_fc`,
    `epi_out` -> (N, 1) logits."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig(), *,
                 generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.register_buffer("resample_filter", setup_filter(RESAMPLE_FILTER, device=device),
                             persistent=False)
        self.frgb = Conv2dLayer(cfg.img_channels, cfg.channels(cfg.img_resolution),
                                kernel_size=1, **kw)
        for res in cfg.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(cfg.channels(res),
                                                          cfg.channels(res // 2), **kw))
        ch4 = cfg.channels(4)
        self.epi_conv = Conv2dLayer(ch4 + cfg.mbstd_num_channels, ch4, **kw)
        self.epi_fc = FullyConnected(ch4 * 16, ch4, **kw)
        self.epi_out = FullyConnected(ch4, 1, **kw)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (N, C, R, R) -> logits (N, 1)."""
        f = self.resample_filter
        x = self.frgb(img, activation="lrelu")
        for res in self.cfg.block_resolutions:
            x = getattr(self, f"b{res}")(x, f)
        x = minibatch_stddev(x, self.cfg.mbstd_group_size, self.cfg.mbstd_num_channels)
        x = self.epi_conv(x, activation="lrelu")
        x = self.epi_fc(x.reshape(x.shape[0], -1), activation="lrelu")
        return self.epi_out(x)
