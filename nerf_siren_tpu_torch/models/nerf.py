"""The vanilla NeRF MLP as an `nn.Module`.

Counterpart of `nerf_siren_tpu/models/nerf.py` (`init_nerf` / `apply_nerf`):
an 8x256 xyz trunk with a skip concat `[emb, h]` at layer 4, a raw-sigma
head, a feature projection concatenated with the embedded view direction
into one width/2 ReLU layer, a sigmoid rgb head, and the optional semantic
`parse` head (`n_classes > 0`), output ``[rgb(3), sigma(1), cls(n)]``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from nerf_siren_tpu_torch.config import NeRFConfig
from nerf_siren_tpu_torch.models.layers import init_linear, linear


class NeRF(nn.Module):
    def __init__(self, cfg: NeRFConfig = NeRFConfig(), *,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device, dtype=dtype)
        layers = []
        for i in range(cfg.depth):
            if i == 0:
                in_dim = cfg.in_channels_xyz
            elif i in cfg.skips:
                in_dim = cfg.width + cfg.in_channels_xyz
            else:
                in_dim = cfg.width
            layers.append(init_linear(in_dim, cfg.width, **kw))
        self.xyz_layers = nn.ModuleList(layers)
        self.xyz_final = init_linear(cfg.width, cfg.width, **kw)
        self.sigma = init_linear(cfg.width, 1, **kw)
        self.dir_layer = init_linear(cfg.width + cfg.in_channels_dir, cfg.width // 2, **kw)
        self.rgb = init_linear(cfg.width // 2, 3, **kw)
        self.parse = None
        if cfg.n_classes > 0:
            self.parse = nn.ModuleList([
                init_linear(cfg.width, cfg.width * 2, **kw),
                init_linear(cfg.width * 2, cfg.n_classes, **kw),
            ])

    def forward(self, xyz_emb: torch.Tensor, dir_emb: Optional[torch.Tensor] = None,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """sigma (..., 1) if `dir_emb` is None, else [rgb, sigma(, cls)]."""
        h = xyz_emb
        for i, layer in enumerate(self.xyz_layers):
            if i in self.cfg.skips:
                h = torch.cat([xyz_emb, h], dim=-1)
            h = torch.relu(linear(layer, h, compute_dtype))

        sigma = linear(self.sigma, h, compute_dtype)
        if dir_emb is None:
            return sigma

        feat = linear(self.xyz_final, h, compute_dtype)
        hd = torch.cat([feat, dir_emb.to(feat.dtype)], dim=-1)
        hd = torch.relu(linear(self.dir_layer, hd, compute_dtype))
        rgb = torch.sigmoid(linear(self.rgb, hd, compute_dtype))

        out = [rgb, sigma]
        if self.parse is not None:
            c = linear(self.parse[0], feat, compute_dtype)
            c = linear(self.parse[1], c, compute_dtype)
            out.append(torch.sigmoid(c))
        return torch.cat(out, dim=-1)
