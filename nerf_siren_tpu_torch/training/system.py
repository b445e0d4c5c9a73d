"""The NeRF training system of the port.

Counterpart of `nerf_siren_tpu/training/system.py` (`TrainState`,
`NeRFSystem`, `epoch_iterator`) for `--mode normal`, with the MLP field or
(`field_type='siren'`) the SIREN field of `models/siren.py`. A system owns
the configs, parameter init, the train steps and the validation render.
State is an explicit `TrainState`: the coarse and fine fields, the
optimizer state and the step. PyTorch runs eagerly, so a step updates the
models and the optimizer state in place and returns the same state with
the step advanced. `training/semantic_system.py` derives the `--mode d3`
system from it.

Four training backends:
- `jnp` (the flag value of the reference scripts): the plain PyTorch field
  in float32 under autograd;
- `fused`: both field passes on K2 (`ops/kernels/fused_mlp_train.py`),
  bf16 operands with float32 accumulation, forward and backward kernels
  on a CUDA device; reference 8x256 topology of the MLP field only;
- `culled`: proxy-culled training (`render/culled_train.py`): an online
  proxy (`models['proxy']`, hidden 64, in the optimizer with the fields)
  places `culled_sel` samples a ray among `culled_candidates`, with
  `culled_uni` strata beside them, and both fields evaluate only those K;
  the step's loss adds `proxy_lambda` times the proxy's regression loss;
- `culled_fused`: `culled` with both field passes on K2 at
  `samples_per_dir` = K.

The steps:
- `train_step`: one update, eagerly;
- `train_step_accum`: one update from micro-batches, gradients averaged;
- `train_scan_batches`: N pre-batched steps, exactly what N `train_step`s
  with the same seed give;
- `train_scan`: N steps on batches drawn uniformly from a ray pool on the
  device;
- `train_scan_importance`: `train_scan` with loss-guided ray sampling.
The three grouped steps run as one `training/graphs.py::StepGroup`: a
captured CUDA graph of the N steps on a card (cached per kind, N, B, pool
size and state), a plain loop on the CPU. They return the state and the
last step's loss and PSNR, as the JAX package's scans do; every step's
are in `last_group.steps` (N, 2 + G: loss, PSNR, then the `GROUP_LOSSES`)
until the next group.

Random draws (stratified perturbation, sigma noise, the fine pass's
sample_pdf) come from a `torch.Generator` on the rays' device, seeded from
(seed, step), so a resumed run draws what the uninterrupted one would.
Every step makes them beforehand (`step_draws`, `draw_step_noise`; a
group's pool steps draw their indices first from the same generator),
outside a group's graph. `jax.random` and torch streams cannot match, so parity with JAX
holds at perturb 0 and noise 0, and for `train_scan*` in distribution.

Data parallel (`data_parallel=parallel/shard_train.py::DataParallel`): the
system is one rank of a process group, its batches are its rows of the
global batch (`epoch_iterator(shard_index=rank, num_shards=world)`, or its
block of the one-process batches: `epoch_iterator(block=(rank, world))`), it draws every
step's noise at the global shape and keeps its rows (`local_step_draws`),
and each step's gradients, losses and squared error go through one
all-reduce (`reduce_step`), eager and inside a `StepGroup`'s graph. So N
ranks compute the one-process step. `train_step_accum` takes each rank's
rows of every micro-batch (JAX's `shard_batched` layout) and makes one
all-reduce of the accumulated gradients and the micro-batches' losses and
squared errors before its update. `train_scan_importance` keeps the whole
pool and one error buffer on every rank: each rank draws the global
batch's indices, trains on its rows, and an all-gather of the batch's
per-ray errors (in global row order) writes the same values into every
rank's buffer, the buffer JAX's scan keeps over its mesh. Without a group
the step has no collective.
`render_sharded` renders a frame in contiguous slabs over a
`parallel/mesh.py::Mesh`, one slab a device, with no collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.models.siren import SirenNeRF, siren_field_fn
from nerf_siren_tpu_torch.render.culled_train import PROXY_HIDDEN, render_rays_culled
from nerf_siren_tpu_torch.render.fast import init_proxy
from nerf_siren_tpu_torch.render.rendering import (StepNoise, draw_noise, render_rays,
                                                   render_rays_chunked)
from nerf_siren_tpu_torch.training.graphs import NOISE, StepGroup
from nerf_siren_tpu_torch.training.losses import loss_dict
from nerf_siren_tpu_torch.training.metrics import mse, psnr
from nerf_siren_tpu_torch.training.optimizers import Optimizer
from nerf_siren_tpu_torch.utils import tracing

BACKENDS = ("jnp", "fused", "culled", "culled_fused")
CULLED = ("culled", "culled_fused")
FIELDS = ("mlp", "siren")


@dataclasses.dataclass
class TrainState:
    step: int
    models: Dict[str, torch.nn.Module]   # 'coarse', (n_importance > 0) 'fine'[, 'points' | 'proxy']
    opt_state: Dict[str, Any]        # `Optimizer` state over `parameters(models)`


def parameters(models: Dict[str, torch.nn.Module]):
    """(model key, tensor name, tensor) in the optimizer's fixed order: each
    model's parameters, or, for a model whose optimizer runs over its whole
    tree (`OPTIMIZES_BUFFERS`: the EG3D renderer, whose JAX optimizer also
    decays `w_avg` and the `noise_const`s), every tensor of its state_dict."""
    out = []
    for k in sorted(models):
        m = models[k]
        items = (m.state_dict(keep_vars=True).items()
                 if getattr(m, "OPTIMIZES_BUFFERS", False) else m.named_parameters())
        out += [(k, n, p) for n, p in items]
    return out


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The random stream of one training step, a function of (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]))
    return g


def draw_step_noise(seed: int, step: int, n_rays: int, cfg: RenderConfig,
                    device, culled: Optional[Tuple[int, int]] = None) -> StepNoise:
    """The draws `render_rays` (with `culled` (n_sel, n_uni),
    `render_rays_culled`) makes from `step_generator(seed, step)` for
    `n_rays` rays under `cfg`, made beforehand, with the same generator, in
    the same order and at the same shapes."""
    return draw_noise(step_generator(seed, step, device), n_rays, cfg, culled)


class GroupedSteps:
    """The grouped training steps of a system: `train_scan_batches`,
    `train_scan` and `train_scan_importance` as one `StepGroup` each. The
    system provides `device`, `optimizer`, `train_cfg`, `LOSS_KEY`,
    `loss_and_grads(state, rays, rgbs, generator, cls_target=None,
    noise=None)`, `step_draws(generator, n_rays)` and optionally
    `after_update(state, outputs)` (run after each optimizer update, inside
    the graph). `GROUP_LOSSES` names the losses besides the sum that a
    group reports, as `train/<name>_loss`."""

    LOSS_KEY = "train/loss"   # the metric of the step's summed loss
    GROUP_LOSSES: Tuple[str, ...] = ()

    def __init__(self, data_parallel=None):
        self._groups: Dict[tuple, StepGroup] = {}
        self.last_group: Optional[StepGroup] = None   # of the last grouped call
        self.dp = data_parallel     # parallel/shard_train.py::DataParallel, or None
        if data_parallel is not None:
            data_parallel.systems.add(self)

    def release_groups(self) -> None:
        """Free the groups' CUDA graphs and drop the groups (built again at
        the next grouped call), also while an error's traceback keeps a
        group alive. A graph that captured an all-reduce holds the process
        group's communicator until it is freed."""
        for group in self._groups.values():
            group.release()
        self._groups.clear()
        self.last_group = None

    def local_draws(self, draws: Dict[str, torch.Tensor], n_local: int
                    ) -> Dict[str, torch.Tensor]:
        """This rank's rows of draws made for the global batch (every draw
        of a step has the rays on its first axis)."""
        return {k: self.dp.local_rows(v, n_local) for k, v in draws.items()}

    def local_step_draws(self, generator: torch.Generator, n_local: int):
        """The step's draws for this process's `n_local` rays: `step_draws`
        at the global batch's shape, then this rank's rows."""
        if self.dp is None:
            return self.step_draws(generator, n_local)
        return self.local_draws(self.step_draws(generator, n_local * self.dp.world), n_local)

    def reduce_step(self, losses: Dict[str, torch.Tensor], pred: torch.Tensor,
                    target: torch.Tensor, grads):
        """(losses, PSNR, gradients) of the step: as they are on one process,
        the global batch's under data parallelism (one all-reduce)."""
        if self.dp is None:
            return losses, psnr(pred.detach(), target), grads
        return self.dp.reduce_step(losses, pred, target, grads)

    def train_scan_batches(self, state: TrainState, rays_b, rgbs_b,
                           seed: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """A group of pre-batched steps, `rays_b` (N, B, 8) and `rgbs_b` (N, B,
        3): exactly the N `train_step`s on those batches with the same seed
        (each step draws from `step_generator(seed, step)`), as one captured
        graph on a card. Returns the state and the last step's metrics."""
        with tracing.span("group"):
            with tracing.span("group.h2d"):
                rays_b = torch.as_tensor(rays_b, dtype=torch.float32, device=self.device)
                rgbs_b = torch.as_tensor(rgbs_b, dtype=torch.float32, device=self.device)
            return self._grouped(state, "batches", {"rays": rays_b, "rgbs": rgbs_b}, seed,
                                 rays_b.shape[0], rays_b.shape[1])

    def train_scan(self, state: TrainState, pool_rays, pool_rgbs, seed: int, n_steps: int,
                   batch_size: Optional[int] = None):
        """`n_steps` steps, each on `batch_size` rays drawn uniformly from the
        pool (moved to the device) with the step's generator; the gather runs
        inside the graph. Returns the state and the last step's metrics."""
        with tracing.span("group"):
            return self._grouped(state, "pool", self._pool(pool_rays, pool_rgbs), seed, n_steps,
                                 batch_size or self.train_cfg.batch_size)

    def train_scan_importance(self, state: TrainState, pool_rays, pool_rgbs, seed: int,
                              n_steps: int, batch_size: Optional[int] = None,
                              alpha: float = 1.0, uniform_frac: float = 0.2):
        """`train_scan` with loss-guided ray sampling: a per-ray error buffer
        over the pool (ones at the start of the call) draws each step's rays
        with probability proportional to (err + 1e-8)^alpha, a `uniform_frac`
        share of them uniformly instead, and takes each step's fresh errors
        of its rays. Returns the state and the last step's metrics."""
        with tracing.span("group"):
            return self._grouped(state, "importance", self._pool(pool_rays, pool_rgbs), seed,
                                 n_steps, batch_size or self.train_cfg.batch_size,
                                 float(alpha), float(uniform_frac))

    def _pool(self, pool_rays, pool_rgbs) -> Dict[str, torch.Tensor]:
        with tracing.span("group.h2d"):
            return {"pool_rays": torch.as_tensor(pool_rays, dtype=torch.float32,
                                                 device=self.device),
                    "pool_rgbs": torch.as_tensor(pool_rgbs, dtype=torch.float32,
                                                 device=self.device)}

    def _grouped(self, state: TrainState, kind: str, inputs: Dict[str, torch.Tensor],
                 seed: int, n: int, b: int, alpha: float = 1.0, uniform_frac: float = 0.0
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Run the group's `StepGroup` on its inputs (`group_inputs`) and
        advance the counts by n. The public grouped calls open the span
        `group` around their copy to the device (`group.h2d`) and this call;
        the draws are `group.draws`, the launch `group.launch`
        (`StepGroup.run`)."""
        with tracing.span("group.draws"):
            inputs = self.group_inputs(state, kind, inputs, seed, n, b, uniform_frac)
        tensors = [p for _, _, p in parameters(state.models)] + [
            t for v in state.opt_state.values() if isinstance(v, list) for t in v]
        n_pool = inputs["pool_rays"].shape[0] if kind != "batches" else 0
        key = (kind, n, b, n_pool, alpha, tuple(t.data_ptr() for t in tensors))
        if key not in self._groups:
            self._groups[key] = StepGroup(self, state, kind, n, alpha)
        self.last_group = self._groups[key]
        out = self.last_group.run(inputs)
        self.optimizer.advance(state.opt_state, n)
        state.step += n
        metrics = {self.LOSS_KEY: out[-1, 0], "train/psnr": out[-1, 1]}
        for j, name in enumerate(self.GROUP_LOSSES):
            metrics[f"train/{name}_loss"] = out[-1, 2 + j]
        return state, metrics

    def group_inputs(self, state: TrainState, kind: str, inputs: Dict[str, torch.Tensor],
                     seed: int, n: int, b: int, uniform_frac: float = 0.0
                     ) -> Dict[str, torch.Tensor]:
        """`inputs` (the batches or the pool) with the next n steps' draws from
        `state`: their indices and noise from each step's generator, and the
        optimizer's scalar table (see `training/graphs.py`)."""
        n_pool = inputs["pool_rays"].shape[0] if kind != "batches" else 0
        world = 1 if self.dp is None else self.dp.world
        draws: Dict[str, list] = {}

        def add(name, value):
            draws.setdefault(name, []).append(value)

        dev = self.device
        for k in range(n):
            gen = step_generator(seed, state.step + k, dev)
            if kind == "pool":
                idx = torch.randint(0, n_pool, (b * world,), generator=gen, device=dev)
                add("idx", idx if self.dp is None else self.dp.local_rows(idx, b))
            elif kind == "importance":   # the global batch's: every rank picks every ray
                add("u_cat", torch.rand(b * world, generator=gen, device=dev))
                add("idx_uni", torch.randint(0, n_pool, (b * world,), generator=gen, device=dev))
                add("take_uni", torch.rand(b * world, generator=gen, device=dev) < uniform_frac)
            for name, v in self.local_step_draws(gen, b).items():
                add(NOISE + name, v)
        inputs = dict(inputs, **{k: torch.stack(v) for k, v in draws.items()})
        inputs["table"] = torch.from_numpy(
            self.optimizer.scalar_table(state.opt_state, n)).to(self.device)
        return inputs


class NeRFSystem(GroupedSteps):
    """Vanilla NeRF trainer: two embeddings (10/4 frequencies), coarse and
    fine NeRF (or SIREN fields: `field_type='siren'`, `siren_hidden` x
    `siren_layers` FiLM layers, a `siren_z_dim` latent, coordinates scaled
    by 2 / `siren_box_warp`), MSE loss (or the semantic losses), PSNR
    logging. The culled backends take `culled_candidates`, `culled_sel`,
    `culled_uni` and `proxy_lambda` (JAX's defaults)."""

    def __init__(self, render_cfg: RenderConfig = RenderConfig(),
                 train_cfg: TrainConfig = TrainConfig(),
                 nerf_cfg: NeRFConfig = NeRFConfig(),
                 steps_per_epoch: int = 1000, train_backend: str = "jnp",
                 device="cuda", field_type: str = "mlp", siren_hidden: int = 256,
                 siren_layers: int = 8, siren_z_dim: int = 100,
                 siren_box_warp: float = 51.0, culled_candidates: int = 32,
                 culled_sel: int = 16, culled_uni: int = 8, proxy_lambda: float = 1.0,
                 data_parallel=None):
        if train_backend not in BACKENDS:
            raise ValueError(f"train_backend {train_backend!r}: one of {BACKENDS}")
        if field_type not in FIELDS:
            raise ValueError(f"field_type {field_type!r}: one of {FIELDS}")
        if train_backend in ("fused", "culled_fused"):
            if field_type != "mlp":
                raise ValueError(f"the {train_backend} backend trains the MLP field (K2), not "
                                 f"{field_type!r}")
            from nerf_siren_tpu_torch.ops.kernels.fused_mlp_train import check_topology

            check_topology(nerf_cfg)
        if train_backend in CULLED and (render_cfg.n_importance <= 0 or field_type != "mlp"):
            raise ValueError("culled training needs a fine network and the MLP field")
        self.culled = dict(n_candidates=culled_candidates, n_sel=culled_sel,
                           n_uni=culled_uni)
        self.proxy_lambda = proxy_lambda
        if train_backend in CULLED:
            self.GROUP_LOSSES = ("proxy",)
        self.field_type = field_type
        self.siren = dict(hidden_dim=siren_hidden, n_layers=siren_layers, z_dim=siren_z_dim,
                          box_sidelength=siren_box_warp)
        self.render_cfg = render_cfg
        self.train_cfg = train_cfg
        self.nerf_cfg = nerf_cfg
        self.steps_per_epoch = steps_per_epoch
        self.train_backend = train_backend
        self.device = torch.device(device)
        self.optimizer = Optimizer(train_cfg, steps_per_epoch)
        self.loss_fn = loss_dict[train_cfg.loss_type]
        super().__init__(data_parallel)

    # -- state ----------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.nn.Module]:
        """Coarse (and fine) fields drawn from `generator` (a CPU generator:
        the weights are drawn on the CPU, then moved to the device)."""
        def field():
            if self.field_type == "siren":
                return SirenNeRF(n_classes=self.nerf_cfg.n_classes, cfg=self.nerf_cfg,
                                 generator=generator, **self.siren)
            return NeRF(self.nerf_cfg, generator=generator)

        models = {"coarse": field()}
        if self.render_cfg.n_importance > 0:
            models["fine"] = field()
        if self.train_backend in CULLED:
            # the online placement proxy; checkpoints save it under 'proxy',
            # where both packages' fast eval reuse it
            models["proxy"] = init_proxy(PROXY_HIDDEN, generator=generator)
        return {k: m.to(self.device) for k, m in models.items()}

    def init_state(self, seed: int) -> TrainState:
        models = self.init_params(torch.Generator().manual_seed(seed))
        return self.state_for(models)

    def state_for(self, models: Dict[str, torch.nn.Module], step: int = 0) -> TrainState:
        """A fresh optimizer state around given models."""
        params = [p for _, _, p in parameters(models)]
        return TrainState(step=step, models=models, opt_state=self.optimizer.init(params))

    # -- steps ----------------------------------------------------------------

    def _plain_field_fn(self):
        """The field_fn of the plain field (None: the MLP's default)."""
        return siren_field_fn if self.field_type == "siren" else None

    def _field_fn(self, rays: torch.Tensor):
        if self.train_backend in ("fused", "culled_fused"):
            from nerf_siren_tpu_torch.ops.kernels.fused_mlp_train import (
                make_fused_train_field_fn)

            return make_fused_train_field_fn(rays[:, 3:6])
        return self._plain_field_fn()

    def _render_train(self, models, rays: torch.Tensor, cfg: RenderConfig,
                      generator: Optional[torch.Generator], noise: Optional[StepNoise]):
        """The training step's render: its outputs, and the proxy's loss on
        the culled backends (else None)."""
        if self.train_backend in CULLED:
            return render_rays_culled(models, rays, cfg, generator,
                                      field_fn=self._field_fn(rays), noise=noise,
                                      **self.culled)
        return render_rays(models, rays, cfg, generator, field_fn=self._field_fn(rays),
                           noise=noise), None

    def loss_and_grads(self, state: TrainState, rays: torch.Tensor, rgbs: torch.Tensor,
                       generator: Optional[torch.Generator],
                       cls_target: Optional[torch.Tensor] = None,
                       noise: Optional[StepNoise] = None):
        """The step's losses, outputs and parameter gradients (the
        parameters are not changed); the draws come from `generator` or are
        `noise`. The backward is the device span `step.backward`."""
        cfg = self.render_cfg.replace(test_time=False)
        params = [p for _, _, p in parameters(state.models)]
        for p in params:
            p.grad = None
        out, proxy_loss = self._render_train(state.models, rays, cfg, generator, noise)
        losses = self.loss_fn(out, rgbs, cls_target=cls_target,
                              global_count=None if self.dp is None else self.dp.mean_count)
        if proxy_loss is not None:
            losses = dict(losses, proxy=proxy_loss,
                          sum=losses["sum"] + self.proxy_lambda * proxy_loss)
        with tracing.device_span("step.backward", self.device):
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
        noise = self.local_step_draws(step_generator(seed, state.step, self.device),
                                      rays.shape[0])
        losses, out, grads = self.loss_and_grads(state, rays, rgbs, None, cls_t, noise=noise)
        rgb_key = "rgb_fine" if "rgb_fine" in out else "rgb_coarse"
        losses, step_psnr, grads = self.reduce_step(losses, out[rgb_key], rgbs, grads)
        params = [p for _, _, p in parameters(state.models)]
        self.optimizer.step(params, grads, state.opt_state)

        metrics = {f"train/{k}_loss" if k != "sum" else self.LOSS_KEY: v.detach()
                   for k, v in losses.items()}
        metrics["train/psnr"] = step_psnr
        state.step += 1
        return state, metrics

    def train_step_accum(self, state: TrainState, batch: Dict[str, Any], seed: int,
                         n_micro: int) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer update from `n_micro` sequential micro-batches of
        `batch` (its rays must divide by n_micro): the gradients are averaged,
        loss and PSNR are micro-batch means. Each micro-batch draws from
        `step_generator(seed, state.step)`, as JAX folds the step into one key
        for all of them. Under data parallelism `batch` is the global batch
        and this rank trains on its block of each micro-batch, with its rows
        of the micro-batch's draws (JAX's `shard_batched`); one all-reduce of
        one bucket (the accumulated gradients, each micro-batch's loss and
        squared error) before the update makes them the global batch's."""
        if self.train_backend in CULLED:
            raise NotImplementedError(
                "train_step_accum supports the jnp/fused backends; use "
                "train_step or train_scan with the culled backends")
        rays = torch.as_tensor(batch["rays"], dtype=torch.float32, device=self.device)
        rgbs = torch.as_tensor(batch["rgbs"], dtype=torch.float32, device=self.device)
        world = 1 if self.dp is None else self.dp.world
        if rays.shape[0] % (n_micro * world):
            raise ValueError(f"batch of {rays.shape[0]} rays does not divide by n_micro "
                             f"{n_micro} x {world} data shards")
        n_local = rays.shape[0] // n_micro // world
        params = [p for _, _, p in parameters(state.models)]
        acc = [torch.zeros_like(p) for p in params]
        losses_m, mse_m = [], []
        for r, c in zip(rays.chunk(n_micro), rgbs.chunk(n_micro)):
            if self.dp is not None:
                r, c = self.dp.local_rows(r, n_local), self.dp.local_rows(c, n_local)
            noise = self.local_step_draws(step_generator(seed, state.step, self.device),
                                          n_local)
            losses, out, grads = self.loss_and_grads(state, r, c, None, noise=noise)
            acc = [a + g / n_micro for a, g in zip(acc, grads)]
            pred = out["rgb_fine" if "rgb_fine" in out else "rgb_coarse"].detach()
            losses_m.append(losses["sum"].detach())
            mse_m.append(mse(pred, c))
        red = acc + [torch.stack(losses_m), torch.stack(mse_m)]
        if self.dp is not None:
            red = self.dp.all_reduce_mean(red)
        loss = torch.zeros((), device=self.device)
        mpsnr = torch.zeros((), device=self.device)
        for m in range(n_micro):
            loss = loss + red[-2][m] / n_micro
            mpsnr = mpsnr + -10.0 * torch.log10(red[-1][m]) / n_micro
        self.optimizer.step(params, red[:-2], state.opt_state)
        state.step += 1
        return state, {"train/loss": loss, "train/psnr": mpsnr}

    def step_draws(self, generator: torch.Generator, n_rays: int) -> StepNoise:
        """The draws `train_step` makes for `n_rays` rays from the step's
        generator, made beforehand (`draw_noise` under the training config)."""
        culled = ((self.culled["n_sel"], self.culled["n_uni"])
                  if self.train_backend in CULLED else None)
        return draw_noise(generator, n_rays, self.render_cfg.replace(test_time=False), culled)

    # -- inference ------------------------------------------------------------

    def frame_renderer(self, models: Dict[str, torch.nn.Module], cfg: RenderConfig):
        """rays -> outputs of the deterministic render under `cfg` on the
        models' device: chunked, on the plain field."""
        field_fn = self._plain_field_fn()
        return lambda rays: render_rays_chunked(models, rays, cfg, None, field_fn=field_fn)

    @torch.no_grad()
    def render(self, models: Dict[str, torch.nn.Module], rays, test_time: bool = False
               ) -> Dict[str, torch.Tensor]:
        """Full-image render (the validation path), deterministic: perturb 0
        and noise 0 (`frame_renderer`)."""
        cfg = self.render_cfg.replace(test_time=test_time, perturb=0.0, noise_std=0.0)
        rays = torch.as_tensor(rays, dtype=torch.float32, device=self.device)
        return self.frame_renderer(models, cfg)(rays)

    @torch.no_grad()
    def render_sharded(self, models: Dict[str, torch.nn.Module], rays, mesh,
                       test_time: bool = False) -> Dict[str, torch.Tensor]:
        """`render` over a `parallel/mesh.py::Mesh`: the rays padded to a
        multiple of the mesh's size, one contiguous slab a device (the
        models `replicate`d), each slab rendered as `render` renders a
        frame, zero collectives; the outputs back on this system's device
        (JAX's `render_sharded`). One device: `render`."""
        from nerf_siren_tpu_torch.parallel.mesh import render_slabs, replicate

        if mesh is None or mesh.size == 1:
            return self.render(models, rays, test_time)
        cfg = self.render_cfg.replace(test_time=test_time, perturb=0.0, noise_std=0.0)
        rays = torch.as_tensor(rays, dtype=torch.float32, device=self.device)
        return render_slabs([self.frame_renderer(m, cfg) for m in replicate(models, mesh)],
                            mesh, rays)

    def current_lr(self, state: TrainState) -> float:
        return float(self.optimizer.schedule(state.step))


def epoch_iterator(all_rays: np.ndarray, all_rgbs: np.ndarray, batch_size: int,
                   seed: int, epoch: int, extras: Optional[Dict[str, np.ndarray]] = None,
                   shard_index: int = 0, num_shards: int = 1,
                   block: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side shuffled batches over the precomputed ray buffer, with the
    JAX package's permutation (numpy `SeedSequence([seed, epoch,
    shard_index])`); drops the ragged tail. `extras` (name -> per-ray
    array, e.g. the semantic datasets' 'cls') are batched with the same
    indices. With `num_shards` > 1 (one process of a data-parallel group)
    the process sees JAX's interleaved shard, rows shard_index, shard_index
    + num_shards, ..., and yields batch_size / num_shards rows a step, as
    many steps as every other shard. With `block` (r, N) (rank r of
    `train --num_chips N`, which splits the one-process batches by rows as
    JAX's one-process mesh does) each batch is cut to its rows [r B / N,
    (r + 1) B / N) before any row is gathered."""
    from nerf_siren_tpu_torch.parallel.shard_train import batch_split_error

    r, n_blocks = block
    err = batch_split_error(batch_size, num_shards) or batch_split_error(batch_size, n_blocks)
    if err:
        raise ValueError(err)
    n = all_rays.shape[0]
    local = np.arange(shard_index, n, num_shards)
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, shard_index]))
    perm = rng.permutation(local)
    local_bs = batch_size // num_shards
    per = local_bs // n_blocks
    for b in range((n // num_shards) // local_bs):
        idx = perm[b * local_bs + r * per:b * local_bs + (r + 1) * per]
        batch = {"rays": all_rays[idx], "rgbs": all_rgbs[idx]}
        for k, v in (extras or {}).items():
            batch[k] = v[idx]
        yield batch
