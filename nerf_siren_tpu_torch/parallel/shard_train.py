"""Data-parallel training steps with explicit collectives.

Counterpart of `nerf_siren_tpu/parallel/shard_train.py`. JAX's step runs
under `shard_map`: each device computes its shard's gradient, then
`psum(g) / n_shards`, and the loss the same way. Here each process of a
`torch.distributed` group (`parallel/multihost.py`) is one shard, and
`DataParallel` is the whole of its communication:

- `reduce_step`: the step's gradients, its losses and the squared error of
  its rays in ONE flat bucket, one `all_reduce(SUM)`, a divide by the world
  size, then the bucket split back (the PSNR is taken from the reduced
  squared error, so it is the global batch's). Every system's step calls
  it, eager and inside `training/graphs.py::StepGroup`, where on NCCL the
  all-reduce is captured into the CUDA graph with the rest of the step. No
  system is wrapped in `DistributedDataParallel`: its buckets and hooks
  are launches a graph cannot take as one collective.
- the rows: rank r holds rows [r B / N, (r + 1) B / N) of the global batch
  of B rays, the block of JAX's row sharding. Every rank makes the step's
  draws at the global shape from the same generator and keeps its block
  (`local_rows`), so N ranks compute the one-process step at any perturb.
- `gather_rows`: an all-gather of per-ray tensors as an autograd function
  (forward `all_gather`; backward the full gradient summed over the ranks,
  then the rank's rows), for the d3 point cloud JAX builds from the whole
  global batch. It runs on gloo (which has no `reduce_scatter`) and NCCL.

- `mean_count`: the global count of a masked mean's valid labels (one
  scalar all-reduce, captured with the step) over the world size. The
  class losses divide each rank's masked sum by it (`training/losses.py`),
  so the average of the ranks' losses and gradients is the global batch's
  masked mean, as JAX's step on a mesh takes it, also where the ranks hold
  different numbers of ignored labels.

Each rank's grads average to the global batch's gradient for losses that
are means over rays with equal shard sizes, or masked means over
`mean_count`, which every loss of the port is.
`make_data_parallel_train_step` is the counterpart of
`make_shard_map_train_step`: JAX's plain MSE step built on the same helper.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from nerf_siren_tpu_torch.training.metrics import mse


def batch_split_error(batch_size: int, num_shards: int) -> Optional[str]:
    """JAX's refusal of a batch that does not split evenly, or None."""
    if num_shards > 1 and batch_size % num_shards != 0:
        return (f"batch_size ({batch_size}) must divide evenly by the number of "
                f"data shards ({num_shards}) so every host feeds the same local "
                f"row count; pick a batch size that is a multiple of {num_shards}")
    return None


class _GatherRows(torch.autograd.Function):
    """all_gather of (n, ...) rows into (world n, ...); the backward sums the
    full gradient over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group, rank, world):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x, group=group)
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, ctx.rank * ctx.n, ctx.n), None, None, None


class DataParallel:
    """One shard of data-parallel training: this process's rank in `group`
    (default: the whole default group)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError("DataParallel needs a torch.distributed process group "
                               "(parallel/multihost.py::initialize_distributed)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.systems = weakref.WeakSet()   # the training systems built on this shard

    def release_graphs(self) -> None:
        """Free the CUDA graphs of every system built on this shard
        (`GroupedSteps.release_groups`): a graph that captured the
        all-reduce holds the communicator until it is freed."""
        for system in list(self.systems):
            system.release_groups()

    # -- rows ---------------------------------------------------------------------

    def local_rows(self, x: torch.Tensor, n_local: int, axis: int = 0,
                   per_row: int = 1) -> torch.Tensor:
        """This rank's block of a global tensor whose `axis` holds
        world x n_local rows of `per_row` entries each."""
        return x.narrow(axis, self.rank * n_local * per_row, n_local * per_row)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `x`, in rank order (differentiable)."""
        return _GatherRows.apply(x, self.group, self.rank, self.world)

    # -- reductions -----------------------------------------------------------------

    def all_reduce_mean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the ranks of each tensor: one flat bucket per dtype,
        one all_reduce(SUM) each, a divide by the world size."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
            dist.all_reduce(flat, group=self.group)
            flat = flat / self.world
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off: off + n].view(tensors[i].shape)
                off += n
        return out

    def mean_count(self, n: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's count `n` (at least 1), over the world size:
        a rank's masked sum over it, averaged over the ranks, is the masked
        sum of the global batch over its count."""
        total = n.detach().to(torch.float32, copy=True).reshape(1)
        dist.all_reduce(total, group=self.group)
        return total[0].clamp_min(1) / self.world

    def reduce_step(self, losses: Dict[str, torch.Tensor], pred: torch.Tensor,
                    target: torch.Tensor, grads: Sequence[torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, List[torch.Tensor]]:
        """The step's gradients, losses and the PSNR of `pred` against
        `target` over the global batch: one all-reduce of one bucket."""
        names = sorted(losses)
        red = self.all_reduce_mean(list(grads) + [losses[k].detach() for k in names]
                                   + [mse(pred.detach(), target)])
        n = len(grads)
        psnr = -10.0 * torch.log10(red[-1])
        return dict(zip(names, red[n:-1])), psnr, red[:n]

    def warm_up(self, device) -> None:
        """One all-reduce and one all-gather on `device`, so the
        communicators exist before a CUDA graph captures the collectives."""
        x = torch.zeros(1, device=device)
        dist.all_reduce(x, group=self.group)
        dist.all_gather([torch.empty_like(x) for _ in range(self.world)], x, group=self.group)


def make_data_parallel_train_step(dp: DataParallel, optimizer, render_cfg) -> Callable:
    """A data-parallel MSE step with explicit collectives (JAX's
    `make_shard_map_train_step`): step(models, opt_state, rays, rgbs,
    generator=None, noise=None) -> (models, opt_state, metrics), `rays` and
    `rgbs` this rank's rows, the models and optimizer state replicated and
    updated in place; `noise` (this rank's rows of the global draws) or
    `generator` makes the draws."""
    from nerf_siren_tpu_torch.render.rendering import render_rays
    from nerf_siren_tpu_torch.training.losses import mse_loss
    from nerf_siren_tpu_torch.training.system import parameters

    cfg = render_cfg.replace(test_time=False)

    def step(models, opt_state, rays, rgbs, generator=None, noise=None):
        params = [p for _, _, p in parameters(models)]
        out = render_rays(models, rays, cfg, generator, noise=noise)
        loss = mse_loss(out, rgbs)["sum"]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        red = dp.all_reduce_mean(grads + [loss.detach()])
        optimizer.step(params, red[:-1], opt_state)
        return models, opt_state, {"train/loss": red[-1]}

    return step
