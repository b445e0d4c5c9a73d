"""The SIREN / FiLM sinusoidal-activation NeRF as an `nn.Module`.

Counterpart of `nerf_siren_tpu/models/siren.py` (`init_siren_nerf`,
`apply_siren_nerf`, `siren_field_fn`):
- FiLM layers sin(freq * (W x + b) + phase), 8 trunk layers (3 -> 256,
  then 256 -> 256), the coordinates scaled by 2 / `box_sidelength`
  (`UniformBoxWarp`);
- the sigma head off the trunk; the colour branch a FiLM layer on
  [ray_dir, trunk], then linear + sigmoid; the optional semantic `parse`
  head (linear h -> 2h -> n_classes, sigmoid);
- a mapping network z (1, z_dim) -> 256 -> 256 -> (n_layers + 1) * hidden *
  2 with LeakyReLU(0.2), split into frequencies (scaled raw * 15 + 30) and
  phase shifts, one slice of `hidden` per FiLM layer, the last for the
  colour layer; a learnable z;
- the SIREN init: the first layer's weight U(+-1/fan_in), the others'
  U(+-sqrt(6/fan_in)/25), their biases and the mapping's the torch default.
The sines take arguments of tens of radians (frequencies about 30), so they
are `torch.sin` in float32, with no approximation.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.layers import init_linear

BOX_WARP_SIDELENGTH = 51.0
MAPPING_HIDDEN = 256


def init_film(in_dim: int, out_dim: int, *, first: bool = False, freq: float = 25.0,
              generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A FiLM layer's linear: weight U(+-bound) (1/fan_in for the first
    layer, sqrt(6/fan_in)/freq otherwise), bias the torch default."""
    layer = init_linear(in_dim, out_dim, generator=generator)
    bound = 1.0 / in_dim if first else math.sqrt(6.0 / in_dim) / freq
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
    return layer


class SirenNeRF(nn.Module):
    """Parameters named as the JAX tree (`convert.siren_to_jax`): `network`,
    `final_layer`, `color_layer_sine`, `color_layer_linear`, `mapping`, `z`
    and (with n_classes > 0) `parse`. `cfg` is the renderer's `NeRFConfig`,
    whose direction encoding `render_rays` builds; the field reads only its
    raw directions."""

    def __init__(self, hidden_dim: int = 256, n_layers: int = 8, z_dim: int = 100,
                 learnable_z: bool = True, n_classes: int = 0,
                 box_sidelength: float = BOX_WARP_SIDELENGTH,
                 cfg: NeRFConfig = NeRFConfig(), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.hidden_dim, self.box_sidelength = cfg, hidden_dim, box_sidelength
        g = dict(generator=generator)
        self.network = nn.ModuleList(
            [init_film(3, hidden_dim, first=True, **g)] +
            [init_film(hidden_dim, hidden_dim, **g) for _ in range(1, n_layers)])
        self.final_layer = init_film(hidden_dim, 1, **g)
        self.color_layer_sine = init_film(hidden_dim + 3, hidden_dim, **g)
        self.color_layer_linear = init_film(hidden_dim, 3, **g)
        self.mapping = nn.ModuleList([
            init_linear(z_dim, MAPPING_HIDDEN, **g),
            init_linear(MAPPING_HIDDEN, MAPPING_HIDDEN, **g),
            init_linear(MAPPING_HIDDEN, (n_layers + 1) * hidden_dim * 2, **g)])
        self.z = None
        if learnable_z:
            self.z = nn.Parameter(torch.randn((1, z_dim), generator=generator))
        self.parse = None
        if n_classes > 0:
            self.parse = nn.ModuleList([init_linear(hidden_dim, 2 * hidden_dim, **g),
                                        init_linear(2 * hidden_dim, n_classes, **g)])

    def mapping_out(self, z: torch.Tensor):
        """z (1, z_dim) -> (frequencies, phase shifts), each (1, (n+1) * hidden)."""
        h = z
        for i, layer in enumerate(self.mapping):
            h = layer(h)
            if i < len(self.mapping) - 1:
                h = nn.functional.leaky_relu(h, 0.2)
        return h.chunk(2, dim=-1)

    def forward(self, xyz: torch.Tensor, ray_dirs: torch.Tensor,
                z: Optional[torch.Tensor] = None, frequencies: Optional[torch.Tensor] = None,
                phase_shifts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """xyz, ray_dirs (..., 3) -> [rgb(3), sigma(1)(, cls(n))]."""
        if frequencies is None:
            frequencies, phase_shifts = self.mapping_out(self.z if z is None else z)
        frequencies = frequencies * 15.0 + 30.0
        h = self.hidden_dim

        def film(layer, x, i):
            return torch.sin(frequencies[..., i * h:(i + 1) * h] * layer(x)
                             + phase_shifts[..., i * h:(i + 1) * h])

        x = xyz * (2.0 / self.box_sidelength)
        for i, layer in enumerate(self.network):
            x = film(layer, x, i)
        sigma = self.final_layer(x)
        rgb = film(self.color_layer_sine, torch.cat([ray_dirs, x], dim=-1), len(self.network))
        out = [torch.sigmoid(self.color_layer_linear(rgb)), sigma]
        if self.parse is not None:
            out.append(torch.sigmoid(self.parse[1](self.parse[0](x))))
        return torch.cat(out, dim=-1)


def siren_field_fn(model: SirenNeRF, xyz: torch.Tensor,
                   dir_emb: Optional[torch.Tensor]) -> torch.Tensor:
    """`render_rays`' field_fn for a `SirenNeRF`: the colour branch takes
    the raw directions, the embedding's passthrough channels dir_emb[:, :3];
    the sigma-only pass (dir_emb None) feeds zero directions and returns
    sigma (R, S, 1)."""
    if dir_emb is None:
        return model(xyz, torch.zeros_like(xyz))[..., 3:4]
    return model(xyz, dir_emb[:, None, :3].expand(xyz.shape))
