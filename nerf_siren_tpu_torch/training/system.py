"""The NeRF training system of the port.

Counterpart of `nerf_siren_tpu/training/system.py` (`TrainState`,
`NeRFSystem`, `epoch_iterator`) for `--mode normal` with the MLP field.
A system owns the configs, parameter init, the train step and the
validation render. State is an explicit `TrainState`: the coarse and fine
`NeRF`s, the optimizer state and the step. PyTorch runs eagerly, so a step
updates the models and the optimizer state in place and returns the same
state with the step advanced.

Two training backends:
- `jnp` (the flag value of the reference scripts): the plain PyTorch field
  in float32 under autograd;
- `fused`: both field passes on K2 (`ops/kernels/fused_mlp_train.py`),
  bf16 operands with float32 accumulation, forward and backward kernels
  on a CUDA device; reference 8x256 topology only.

Random draws (stratified perturbation, sigma noise, the fine pass's
sample_pdf) come from a `torch.Generator` on the rays' device, seeded from
(seed, step), so a resumed run draws what the uninterrupted one would.
The JAX package's scanned and accumulating steps (`train_scan*`,
`train_step_accum`) and `render_sharded` are not ported yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.render.rendering import render_rays, render_rays_chunked
from nerf_siren_tpu_torch.training.losses import loss_dict
from nerf_siren_tpu_torch.training.metrics import psnr
from nerf_siren_tpu_torch.training.optimizers import Optimizer

BACKENDS = ("jnp", "fused")


@dataclasses.dataclass
class TrainState:
    step: int
    models: Dict[str, NeRF]          # 'coarse' and (with n_importance > 0) 'fine'
    opt_state: Dict[str, Any]        # `Optimizer` state over `parameters(models)`


def parameters(models: Dict[str, NeRF]):
    """(model key, parameter name, tensor) in the optimizer's fixed order."""
    return [(k, n, p) for k in sorted(models) for n, p in models[k].named_parameters()]


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The random stream of one training step, a function of (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return g


class NeRFSystem:
    """Vanilla NeRF trainer: two embeddings (10/4 frequencies), coarse and
    fine NeRF, MSE loss (or the semantic losses), PSNR logging."""

    def __init__(self, render_cfg: RenderConfig = RenderConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 nerf_cfg: NeRFConfig = NeRFConfig(),
                 steps_per_epoch: int = 1000, train_backend: str = "jnp",
                 device="cuda"):
        if train_backend not in BACKENDS:
            raise ValueError(f"train_backend {train_backend!r}: the port has {BACKENDS}; "
                             "'culled' and 'culled_fused' come with ROADMAP slice 6")
        if train_backend == "fused":
            from nerf_siren_tpu_torch.ops.kernels.fused_mlp_train import check_topology

            check_topology(nerf_cfg)
        self.render_cfg = render_cfg
        self.train_cfg = train_cfg
        self.nerf_cfg = nerf_cfg
        self.steps_per_epoch = steps_per_epoch
        self.train_backend = train_backend
        self.device = torch.device(device)
        self.optimizer = Optimizer(train_cfg, steps_per_epoch)
        self.loss_fn = loss_dict[train_cfg.loss_type]

    # -- state ----------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> Dict[str, NeRF]:
        """Coarse (and fine) fields drawn from `generator` (a CPU generator:
        the weights are drawn on the CPU, then moved to the device)."""
        models = {"coarse": NeRF(self.nerf_cfg, generator=generator)}
        if self.render_cfg.n_importance > 0:
            models["fine"] = NeRF(self.nerf_cfg, generator=generator)
        return {k: m.to(self.device) for k, m in models.items()}

    def init_state(self, seed: int) -> TrainState:
        models = self.init_params(torch.Generator().manual_seed(seed))
        return self.state_for(models)

    def state_for(self, models: Dict[str, NeRF], step: int = 0) -> TrainState:
        """A fresh optimizer state around given models."""
        params = [p for _, _, p in parameters(models)]
        return TrainState(step=step, models=models, opt_state=self.optimizer.init(params))

    # -- steps ----------------------------------------------------------------

    def _field_fn(self, rays: torch.Tensor):
        if self.train_backend == "fused":
            from nerf_siren_tpu_torch.ops.kernels.fused_mlp_train import (
                make_fused_train_field_fn)

            return make_fused_train_field_fn(rays[:, 3:6])
        return None

    def loss_and_grads(self, state: TrainState, rays: torch.Tensor, rgbs: torch.Tensor,
                       generator: Optional[torch.Generator],
                       cls_target: Optional[torch.Tensor] = None):
        """The step's losses, outputs and parameter gradients (the
        parameters are not changed)."""
        cfg = self.render_cfg.replace(test_time=False)
        params = [p for _, _, p in parameters(state.models)]
        for p in params:
            p.grad = None
        out = render_rays(state.models, rays, cfg, generator, field_fn=self._field_fn(rays))
        losses = self.loss_fn(out, rgbs, cls_target=cls_target)
        losses["sum"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None
        return losses, out, grads

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer update on `batch` ({'rays' (B, 8), 'rgbs' (B, 3)[,
        'cls']}, numpy or torch); the step's randomness is drawn from
        `step_generator(seed, state.step)`. Metrics stay on the device."""
        rays = torch.as_tensor(batch["rays"], dtype=torch.float32, device=self.device)
        rgbs = torch.as_tensor(batch["rgbs"], dtype=torch.float32, device=self.device)
        cls_t = batch.get("cls")
        if cls_t is not None:
            cls_t = torch.as_tensor(cls_t, device=self.device)
        gen = step_generator(seed, state.step, self.device)
        losses, out, grads = self.loss_and_grads(state, rays, rgbs, gen, cls_t)
        params = [p for _, _, p in parameters(state.models)]
        self.optimizer.step(params, grads, state.opt_state)

        rgb_key = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"
        metrics = {f"train/{k}_loss" if k != "sum" else "train/loss": v.detach()
                   for k, v in losses.items()}
        metrics["train/psnr"] = psnr(out[rgb_key].detach(), rgbs)
        state.step += 1
        return state, metrics

    # -- inference ------------------------------------------------------------

    @torch.no_grad()
    def render(self, models: Dict[str, NeRF], rays, test_time: bool = False
               ) -> Dict[str, torch.Tensor]:
        """Chunked full-image render (the validation path), deterministic:
        perturb 0 and noise 0, on the plain field."""
        cfg = self.render_cfg.replace(test_time=test_time, perturb=0.0, noise_std=0.0)
        rays = torch.as_tensor(rays, dtype=torch.float32, device=self.device)
        return render_rays_chunked(models, rays, cfg, None)

    def current_lr(self, state: TrainState) -> float:
        return float(self.optimizer.schedule(state.step))


def epoch_iterator(all_rays: np.ndarray, all_rgbs: np.ndarray, batch_size: int,
                   seed: int, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side shuffled batches over the precomputed ray buffer, with the
    JAX package's single-process permutation (numpy
    `SeedSequence([seed, epoch, 0])`); drops the ragged tail."""
    n = all_rays.shape[0]
    perm = np.random.default_rng(np.random.SeedSequence([seed, epoch, 0])).permutation(n)
    for b in range(n // batch_size):
        idx = perm[b * batch_size:(b + 1) * batch_size]
        yield {"rays": all_rays[idx], "rgbs": all_rgbs[idx]}
