"""The EG3D system's render half.

Counterpart of `nerf_siren_tpu/training/eg3d_system.py::EG3DSystem.render`
(reference: system.py:137-144): a frame's planes are synthesised once
(mapping + StyleGAN2 synthesis) and packed into a bf16 sampling table, then
the rays are rendered in `chunk`-ray tiles by `importance_render`, sampling
the planes through the plain gather (`plane_sampler='gather'`) or the
kernel K5 (`'kernel'`). A Python loop takes the place of `lax.map`, so the
last tile needs no padding. `train_step`, the training scans and
`render_sharded` come with later slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from nerf_siren_tpu_torch.render.rendering import map_chunks
from nerf_siren_tpu_torch.render.triplane import (EG3DRenderer, TriPlaneConfig,
                                                  importance_render, make_kernel_plane_sampler,
                                                  pack_planes_for_sampling)

EG3D_VAL_CHUNK = 4096   # reference system.py:137
PLANE_SAMPLERS = ("gather", "kernel")
OUTPUTS = ("rgb_coarse", "depth_coarse", "opacity_coarse", "rgb_fine", "depth_fine",
           "opacity_fine")


class EG3DSystem:
    def __init__(self, triplane_cfg: Optional[TriPlaneConfig] = None,
                 plane_sampler: str = "gather"):
        if plane_sampler not in PLANE_SAMPLERS:
            raise ValueError(f"plane_sampler {plane_sampler!r}: one of {PLANE_SAMPLERS}")
        self.cfg = triplane_cfg if triplane_cfg is not None else TriPlaneConfig()
        self.plane_sampler = plane_sampler

    def init_model(self, generator: Optional[torch.Generator] = None, device=None,
                   seed: int = 0) -> EG3DRenderer:
        """An `EG3DRenderer` of this config (the checkpoint's name for it is
        `eg3d_renderer`)."""
        return EG3DRenderer(self.cfg, seed, generator=generator, device=device)

    def frame_planes(self, model: EG3DRenderer) -> torch.Tensor:
        """Mapping + synthesis once, packed: the frame's bf16 sampling table
        (1, 3, H+2, W+2, C)."""
        with torch.no_grad():
            planes = model.planes(model.mapping(model.z))
            return pack_planes_for_sampling(planes, torch.bfloat16)

    def render_packed(self, model: EG3DRenderer, packed: torch.Tensor, rays: torch.Tensor,
                      chunk: int = EG3D_VAL_CHUNK) -> Dict[str, torch.Tensor]:
        """Render rays (R, >= 6) [o, d, ...] on a frame's table -> dict of
        (R, ...) outputs, `chunk` rays per tile."""
        sampler = (make_kernel_plane_sampler(packed, self.cfg.rendering.box_warp)
                   if self.plane_sampler == "kernel" else None)

        def tile(t: torch.Tensor) -> Dict[str, torch.Tensor]:
            out = importance_render(packed, model.decoder, t[None, :, 0:3], t[None, :, 3:6],
                                    self.cfg.rendering, packed=True, sampler=sampler)
            return {k: v[0] for k, v in zip(OUTPUTS, out)}

        with torch.no_grad():
            return map_chunks(tile, rays, chunk)

    def render(self, model: EG3DRenderer, rays: torch.Tensor,
               chunk: int = EG3D_VAL_CHUNK) -> Dict[str, torch.Tensor]:
        """Chunked deterministic render of one frame (planes once per call)."""
        return self.render_packed(model, self.frame_planes(model), rays, chunk)
