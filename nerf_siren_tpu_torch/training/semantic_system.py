"""The semantic NeRF training system (`--mode d3` and `d3_ib`).

Counterpart of `nerf_siren_tpu/training/semantic_system.py`
(`NeRF3DSystem`, `NeRF3DSystem_ib`): the NeRF trainer of
`training/system.py` with a point network beside its fields, PointNet
(`semantic_network='pointnet'`) or the dense voxel UNet ('conv3d'), over
each step's weight-sampled point cloud (`render/rendering_3d.py`), trained
with the msece / msenll losses against per-ray class labels. With
`no_grad_on_nerf` (the default) the fields run without gradients: their
gradients are zeros, so Adam leaves them bit-unchanged, as in JAX. The
fields are the plain MLP (`jnp`), as JAX's: its `NeRF3DSystem` takes no
training backend.

`train_step` takes the batch's 'cls'; `train_scan_batches(..., cls_b)`
runs N steps with per-step class targets as one `training/graphs.py::
StepGroup` (a captured CUDA graph on a card). JAX's `train_scan` and
`train_scan_importance` take no class targets, so the port refuses them
here. `render` tiles the rays by `chunk` and builds one cloud per tile, as
JAX does; `render_sharded` does so on each device's slab. Under data
parallelism (`data_parallel`) every rank builds the global batch's cloud
(`render/rendering_3d.py`), as JAX's step on a mesh does.
"""
from __future__ import annotations

from typing import Dict

import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.models.pointnet import PointNetDenseCls
from nerf_siren_tpu_torch.models.voxel_unet import VoxelUNet
from nerf_siren_tpu_torch.render.rendering import map_chunks
from nerf_siren_tpu_torch.render.rendering_3d import render_rays_3d
from nerf_siren_tpu_torch.training.system import NeRFSystem

SEMANTIC_NETWORKS = ("pointnet", "conv3d")


def make_points_network(semantic_network: str, n_classes: int, generator=None):
    """The point network of a d3 system: PointNet (k classes, 6 inputs) or
    the voxel UNet (7 inputs, n_classes outputs)."""
    if semantic_network == "pointnet":
        return PointNetDenseCls(k=n_classes, inc=6, generator=generator)
    if semantic_network == "conv3d":
        return VoxelUNet(in_channels=7, out_channels=n_classes, generator=generator)
    raise ValueError(f"semantic_network {semantic_network!r}: one of {SEMANTIC_NETWORKS}")


class NeRF3DSystem(NeRFSystem):
    LOSS_KEY = "train/total_loss"

    def __init__(self, render_cfg: RenderConfig = RenderConfig(),
                 train_cfg: TrainConfig = TrainConfig(loss_type="msenll"),
                 nerf_cfg: NeRFConfig = NeRFConfig(), steps_per_epoch: int = 1000,
                 semantic_network: str = "pointnet", n_classes: int = 6,
                 point_capacity: int = 8192, no_grad_on_nerf: bool = True,
                 point_norm: str = "frob", device="cuda", data_parallel=None):
        super().__init__(render_cfg, train_cfg, nerf_cfg, steps_per_epoch, device=device,
                         data_parallel=data_parallel)
        if semantic_network not in SEMANTIC_NETWORKS:
            raise ValueError(f"semantic_network {semantic_network!r}: one of "
                             f"{SEMANTIC_NETWORKS}")
        self.semantic_network = semantic_network
        self.n_classes = n_classes
        self.point_capacity = point_capacity
        self.no_grad_on_nerf = no_grad_on_nerf
        self.point_norm = point_norm

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.nn.Module]:
        models = super().init_params(generator)
        models["points"] = make_points_network(self.semantic_network, self.n_classes,
                                               generator).to(self.device)
        return models

    def _semantic_kwargs(self) -> dict:
        return dict(n_classes=self.n_classes, point_capacity=self.point_capacity,
                    point_norm=self.point_norm)

    def _render_train(self, models, rays, cfg, generator, noise):
        return render_rays_3d(models, rays, cfg, generator, no_grad_on_nerf=self.no_grad_on_nerf,
                              noise=noise, data_parallel=self.dp,
                              **self._semantic_kwargs()), None

    def train_step(self, state, batch, seed: int):
        """One update on a batch {'rays', 'rgbs', 'cls'} (any leading shape:
        the image-batch mode's (B, H*W, ...) is flattened)."""
        batch = {"rays": torch.as_tensor(batch["rays"]).reshape(-1, 8),
                 "rgbs": torch.as_tensor(batch["rgbs"]).reshape(-1, 3),
                 "cls": torch.as_tensor(batch["cls"]).reshape(-1)}
        return super().train_step(state, batch, seed)

    def train_scan_batches(self, state, rays_b, rgbs_b, seed: int, cls_b=None):
        """N pre-batched steps with per-step class targets `cls_b` (N, B) as
        one `StepGroup`: exactly the N `train_step`s on those batches."""
        if cls_b is None:
            raise ValueError("the semantic system's steps need class targets (cls_b)")
        n = torch.as_tensor(rays_b).shape[0]
        rays_b = torch.as_tensor(rays_b, dtype=torch.float32,
                                 device=self.device).reshape(n, -1, 8)
        inputs = {"rays": rays_b,
                  "rgbs": torch.as_tensor(rgbs_b, dtype=torch.float32,
                                          device=self.device).reshape(n, -1, 3),
                  "cls": torch.as_tensor(cls_b, device=self.device).reshape(n, -1).long()}
        return self._grouped(state, "batches", inputs, seed, n, rays_b.shape[1])

    def train_scan(self, *args, **kwargs):
        raise NotImplementedError("train_scan draws its rays from a pool without class "
                                  "targets (as JAX's): use train_scan_batches(..., cls_b)")

    def train_scan_importance(self, *args, **kwargs):
        raise NotImplementedError("train_scan_importance draws its rays from a pool without "
                                  "class targets (as JAX's): use "
                                  "train_scan_batches(..., cls_b)")

    def frame_renderer(self, models, cfg):
        """rays -> the semantic render under `cfg` (adds the cls maps): one
        point cloud per `chunk`-ray tile."""
        return lambda rays: map_chunks(
            lambda t: render_rays_3d(models, t, cfg, None, no_grad_on_nerf=False,
                                     **self._semantic_kwargs()), rays, cfg.chunk)


NeRF3DSystem_ib = NeRF3DSystem   # the reference's name; batches are flat rays already
