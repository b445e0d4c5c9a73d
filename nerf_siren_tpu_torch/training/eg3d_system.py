"""The EG3D system: single-scene training and the chunked frame render.

Counterpart of `nerf_siren_tpu/training/eg3d_system.py::EG3DSystem`
(reference: system.py:17-169). The only latent is the renderer's learnable
z; the StyleGAN2 discriminator is not used (as in the reference).

Training. The state is a `training/system.py::TrainState` whose models are
{'eg3d_renderer': EG3DRenderer}. As JAX's optax transform runs over the
renderer's whole tree, the optimizer takes every tensor of the renderer's
state_dict (`EG3DRenderer.OPTIMIZES_BUFFERS`): the parameters, and the
buffers `w_avg` and `noise_const`, which the step differentiates as JAX
differentiates its leaves: a `noise_const` gets the gradient of its const
noise term (noise_const x noise_strength, so none while the strength is
0), `w_avg` none (truncation is off in training), and a weight decay moves
both. A step renders the
batch through `eg3d_render` (noise mode 'const', planes in float32,
sampled by the differentiable plain gather), its loss is the coarse +
fine MSE, and after the optimizer update the `w_avg` EMA takes the
mapping output of the step's forward, that is of the pre-step mapping and
z (`after_update`). Each step is stochastic, as JAX's: its draws (the
strata's uniforms, the pdf's u and, with density noise, the sigma noise;
`render/triplane.py::eg3d_noise_shapes`) come from
`training/system.py::step_generator(seed, step)`, or are handed in
(`loss_and_grads(..., noise=draws)`), which is how a captured group gets
them and how the tests replay JAX's key chain. `train_scan_batches`,
`train_scan` and `train_scan_importance` are `GroupedSteps`: one captured
CUDA graph of the N steps on a card, a loop on the CPU. Metrics:
'train/loss' and 'train/psnr' (of the fine rgb).

Rendering (reference system.py:137-144): a frame's planes are synthesised
once (mapping + StyleGAN2 synthesis) and packed into a bf16 sampling
table, then the rays are rendered in `chunk`-ray tiles by
`importance_render`, sampling the planes through the plain gather
(`plane_sampler='gather'`) or the kernel K5 ('kernel'). A Python loop
takes the place of `lax.map`, so the last tile needs no padding.
`render_sharded` is not ported yet (ROADMAP slice 6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from nerf_siren_tpu_torch.config import TrainConfig
from nerf_siren_tpu_torch.render.rendering import map_chunks
from nerf_siren_tpu_torch.render.triplane import (EG3DRenderer, TriPlaneConfig, draw_eg3d_noise,
                                                  eg3d_render, importance_render,
                                                  make_kernel_plane_sampler,
                                                  pack_planes_for_sampling)
from nerf_siren_tpu_torch.training.losses import mse_loss
from nerf_siren_tpu_torch.training.metrics import psnr
from nerf_siren_tpu_torch.training.optimizers import Optimizer
from nerf_siren_tpu_torch.training.system import (GroupedSteps, TrainState, parameters,
                                                  step_generator)

EG3D_VAL_CHUNK = 4096   # reference system.py:137
MODEL = "eg3d_renderer"  # the state's model key and the checkpoint's name
PLANE_SAMPLERS = ("gather", "kernel")
OUTPUTS = ("rgb_coarse", "depth_coarse", "opacity_coarse", "rgb_fine", "depth_fine",
           "opacity_fine")


class EG3DSystem(GroupedSteps):
    def __init__(self, triplane_cfg: Optional[TriPlaneConfig] = None,
                 plane_sampler: str = "gather", train_cfg: TrainConfig = TrainConfig(),
                 steps_per_epoch: int = 1000, device="cuda"):
        if plane_sampler not in PLANE_SAMPLERS:
            raise ValueError(f"plane_sampler {plane_sampler!r}: one of {PLANE_SAMPLERS}")
        self.cfg = triplane_cfg if triplane_cfg is not None else TriPlaneConfig()
        self.plane_sampler = plane_sampler
        self.train_cfg = train_cfg
        self.steps_per_epoch = steps_per_epoch
        self.device = torch.device(device)
        self.optimizer = Optimizer(train_cfg, steps_per_epoch)
        super().__init__()

    # -- state ----------------------------------------------------------------

    def init_model(self, generator: Optional[torch.Generator] = None, device=None,
                   seed: int = 0) -> EG3DRenderer:
        """An `EG3DRenderer` of this config (the checkpoint's name for it is
        `eg3d_renderer`)."""
        return EG3DRenderer(self.cfg, seed, generator=generator, device=device)

    def init_state(self, seed: int) -> TrainState:
        """Weights drawn from a CPU generator seeded `seed`, then moved to the
        device; z from numpy's RandomState(0), as JAX's init."""
        model = self.init_model(torch.Generator().manual_seed(seed)).to(self.device)
        return self.state_for({MODEL: model})

    def state_for(self, models: Dict[str, torch.nn.Module], step: int = 0) -> TrainState:
        """A fresh optimizer state around {'eg3d_renderer': model}."""
        tensors = [p for _, _, p in parameters(models)]
        return TrainState(step=step, models=models, opt_state=self.optimizer.init(tensors))

    # -- steps ----------------------------------------------------------------

    def step_draws(self, generator: torch.Generator, n_rays: int) -> Dict[str, torch.Tensor]:
        """The draws of one step on `n_rays` rays, from `generator`."""
        return draw_eg3d_noise(generator, 1, n_rays, self.cfg.rendering)

    def loss_and_grads(self, state: TrainState, rays: torch.Tensor, rgbs: torch.Tensor,
                       generator: Optional[torch.Generator] = None, cls_target=None,
                       noise: Optional[Dict[str, torch.Tensor]] = None):
        """The step's losses, outputs and gradients of every optimized tensor
        (zeros where a tensor takes no part); nothing but the buffers'
        requires_grad flags is changed. The draws are `noise`,
        or are made from `generator`; with neither the render is
        deterministic. The outputs carry 'w_pre', the detached mapping
        output of this forward, for `after_update`."""
        tensors = [p for _, _, p in parameters(state.models)]
        for p in tensors:
            p.grad = None
            p.requires_grad_(True)     # the buffers too: JAX differentiates every leaf
        if noise is None and generator is not None:
            noise = self.step_draws(generator, rays.shape[0])
        w_pre: list = []
        out = eg3d_render(state.models[MODEL], rays[:, 0:3], rays[:, 3:6], "const",
                          draws=noise, w_pre=w_pre)
        losses = mse_loss(out, rgbs)
        losses["sum"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in tensors]
        for p in tensors:
            p.grad = None
        out["w_pre"] = w_pre[0]
        return losses, out, grads

    @torch.no_grad()
    def after_update(self, state: TrainState, outputs: Dict[str, torch.Tensor]) -> None:
        """The `w_avg` EMA, after the optimizer has updated (and, with weight
        decay, decayed) the buffer, from the step's pre-step mapping output
        (JAX eg3d_system.py:92-103)."""
        mapping = state.models[MODEL].backbone.mapping
        mapping.w_avg.copy_(mapping.w_avg_ema(outputs["w_pre"]))

    def train_step(self, state: TrainState, batch: Dict[str, Any], seed: int,
                   noise: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update on `batch` ({'rays' (B, >= 6), 'rgbs' (B, 3)}, numpy or
        torch), its draws from `step_generator(seed, state.step)` or, given,
        `noise`. Metrics stay on the device."""
        rays = torch.as_tensor(batch["rays"], dtype=torch.float32, device=self.device)
        rgbs = torch.as_tensor(batch["rgbs"], dtype=torch.float32, device=self.device)
        gen = step_generator(seed, state.step, self.device) if noise is None else None
        losses, out, grads = self.loss_and_grads(state, rays, rgbs, gen, noise=noise)
        self.optimizer.step([p for _, _, p in parameters(state.models)], grads,
                            state.opt_state)
        self.after_update(state, out)
        state.step += 1
        return state, {self.LOSS_KEY: losses["sum"].detach(),
                       "train/psnr": psnr(out["rgb_fine"].detach(), rgbs)}

    def current_lr(self, state: TrainState) -> float:
        return float(self.optimizer.schedule(state.step))

    # -- rendering --------------------------------------------------------------

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
