"""Data-parallel training traffic: `train.py --num_chips N`'s grouped path
on N ranks, timed on rank 0.

Rank 0 runs in the harness's process on the run's device; the driver
spawns ranks 1 .. N-1 (`ranks` in the traffic) with `torch.multiprocessing`
as `train.py::spawn_ranks` does, rank r on device r (NCCL between cards,
gloo on the CPU, where the ranks share the host's cores), and every rank
joins and leaves the group as a rank of `train.py` does
(`parallel/multihost.py`: `rank_store`, `rank_threads`, `local_group`).
Every rank parses the train
CLI's flags of the cell, builds the system `train.py` builds from them
with a `DataParallel` (`build_system`), makes the same weights from the
seed and the same ray table, and takes its block of rows of each global
batch of N x `rays_per_step` rays (`epoch_iterator(block=(rank, N))`, as a
rank of `train.py --num_chips N` does): `steps_per_dispatch` steps a group
through `train_scan_batches`, one captured CUDA graph a group on a card
with the step's all-reduce inside it.

Every rank runs the same groups, in this order: the `CHECKED_GROUPS` the
check compares (rank 0 keeps their global batches, its losses, Adam's
first moment and the weights after the first group and after the last:
the all-reduce makes them the global batch's), `warmup_groups`,
`timing_groups` that rank 0 times to size the window (its count of groups,
enough for `--seconds`, broadcast from rank 0), `traced_groups` in a
traced run (rank 0 profiles them), then the window, which ends in a
synchronise. The rate (the cell's `e2e_names`) counts every rank's rays:
the window's groups x steps x `rays_per_step` x N over rank 0's window.
After the window every rank's weights are gathered on rank 0:
`rank_weight_gap` is the largest difference of a rank's from rank 0's.
Every rank then frees its program and leaves the group (`local_group`
frees the CUDA graphs that captured the all-reduce first, also when a
rank fails), and the reference follows the checked steps on rank 0, on
the global batches and their draws (`drivers/train.py::readings`).
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from benchmark import scenes
from benchmark.drivers import train as single
from benchmark.drivers.train import free_program, model_of, sync
from benchmark.harness import Run, traced_slice

CHECKED_GROUPS = single.CHECKED_GROUPS
GROUP_TIMEOUT = datetime.timedelta(seconds=300)   # a collective that waits longer fails


def cli_args(cfg: dict, traffic: dict, world: int) -> list:
    """The train CLI's flags of the cell: `--num_chips` N and the global batch."""
    return ["--root_dir", ".", "--N_samples", str(cfg["n_samples"]),
            "--N_importance", str(cfg["n_importance"]), "--perturb", str(traffic["perturb"]),
            "--noise_std", str(traffic["noise_std"]),
            "--batch_size", str(traffic["rays_per_step"] * world),
            "--train_backend", traffic["train_backend"], "--optimizer", "adam",
            "--lr", str(traffic["lr"]), "--lr_scheduler", traffic["lr_scheduler"],
            "--decay_step", *[str(d) for d in traffic["decay_step"]],
            "--decay_gamma", str(traffic["decay_gamma"]),
            "--num_epochs", str(traffic["num_epochs"]),
            "--steps_per_dispatch", str(traffic["steps_per_dispatch"]),
            "--num_chips", str(world)]


def global_batches(rays, rgbs, batch: int, seed: int, block=(0, 1)):
    """`epoch_iterator`'s batches of the global `batch`, epoch after epoch
    (with `block` (r, N), rank r's rows of each)."""
    from nerf_siren_tpu_torch.training.system import epoch_iterator

    return (b for epoch in itertools.count()
            for b in epoch_iterator(rays, rgbs, batch, seed, epoch, block=block))


def checked_inputs(run, world: int) -> dict:
    """The weights and the checked groups' global batches, made as every
    rank makes them: what the reference needs."""
    cfg, tr, dev = run.config, run.traffic, run.device
    model = model_of(cfg)
    with run.spans.span("setup.weights"):
        weights = model.make_weights(cfg, scenes.torch_generator(run.seed, dev, 0),
                                     tr["weights"])
    with run.spans.span("setup.rays"):
        rays, rgbs = scenes.ray_table(tr["cameras"], run.seed, dev)
    batches = global_batches(rays, rgbs, tr["rays_per_step"] * world, run.seed)
    checked = [(x["rays"], x["rgbs"]) for x in
               itertools.islice(batches, CHECKED_GROUPS * tr["steps_per_dispatch"])]
    return dict(model=model, weights=weights, rays=rays, rgbs=rgbs, checked=checked)


def prepare(run, dp) -> dict:
    """One rank's set-up up to the checked groups: the flags, the weights,
    the data, the system and its state after those groups, and, on rank 0,
    what the check keeps."""
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.train import build_system

    cfg, tr, dev = run.config, run.traffic, run.device
    with run.spans.span("setup.flags"):
        hparams = get_opts(cli_args(cfg, tr, dp.world))
    ctx = checked_inputs(run, dp.world)
    model, b = ctx["model"], tr["rays_per_step"]
    with run.spans.span("setup.system"):
        system = build_system(hparams, cfg["white_back"],
                              max(1, len(ctx["rays"]) // hparams.batch_size), dev,
                              data_parallel=dp)
        if system.nerf_cfg != model.nerf_config(cfg):
            raise RuntimeError("the train CLI built another field than the configuration's")
        state = system.state_for(model.program_models(cfg, ctx["weights"], dev))
    local = global_batches(ctx.pop("rays"), ctx.pop("rgbs"), b * dp.world, run.seed,
                           (dp.rank, dp.world))

    def group(n):
        with run.spans.span("batch_prep"):
            bs = [next(local) for _ in range(n)]
            return np.stack([x["rays"] for x in bs]), np.stack([x["rgbs"] for x in bs])

    losses, moment, mid = [], None, None
    for g_k in range(CHECKED_GROUPS):
        g = group(tr["steps_per_dispatch"])
        with run.spans.span(f"setup.checked_group.{g_k + 1}"):
            state, _ = system.train_scan_batches(state, g[0], g[1], run.seed)
            losses += [float(v) for v in system.last_group.steps[:, 0]]
        if moment is None:
            moment = {k: v.clone() for k, v in model.first_moments(system, state).items()}
            mid = single.leaves(model, state)
    return dict(ctx, system=system, state=state, group=group, losses=losses, moment=moment,
                mid=mid, after=single.leaves(model, state))


def rank_loop(run, dp) -> dict:
    """One rank's groups (see the module's docstring); rank 0 fills `run`."""
    tr, dev = run.traffic, run.device
    ctx = prepare(run, dp)
    n = tr["steps_per_dispatch"]
    loss_key = ctx["system"].LOSS_KEY

    def step_group():
        rb, gb = ctx["group"](n)
        with run.spans.span("dispatch"):
            return ctx["system"].train_scan_batches(ctx["state"], rb, gb, run.seed)[1]

    with run.spans.span("setup.warmup"):
        for _ in range(tr["warmup_groups"]):
            step_group()
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(tr["timing_groups"]):
            step_group()
        sync(dev)
        per_group = (time.perf_counter() - t0) / tr["timing_groups"]
        count = torch.tensor([max(1, math.ceil(run.seconds / per_group))], device=dev)
        dist.broadcast(count, 0)
    if run.trace:
        with traced_slice(run) if dp.rank == 0 else contextlib.nullcontext():
            for _ in range(tr["traced_groups"]):
                step_group()
        run.readings["traced_steps"] = tr["traced_groups"] * n
    run.setup_done()
    t0 = time.perf_counter()
    group_losses = [step_group()[loss_key] for _ in range(int(count[0]))]
    sync(dev)
    window = time.perf_counter() - t0
    steps = len(group_losses) * n
    run.attempted = steps
    run.failed = n * int((~torch.isfinite(torch.stack(group_losses))).sum())
    run.e2e[run.workload["e2e_names"]["rays_per_s"]] = (steps * tr["rays_per_step"] * dp.world
                                                        / window)
    run.readings.update(window_s=window, steps=steps, t_window=t0,
                        step_flops=ctx["model"].step_flops(run.config, tr))
    k_flops, k_bytes = ctx["model"].kernel_step_work(run.config, tr)
    run.readings.update(kernel_step_flops=k_flops, kernel_step_bytes=k_bytes)
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    flat = torch.cat([v.reshape(-1) for v in ctx["model"].state_leaves(ctx["state"]).values()])
    parts = [torch.empty_like(flat) for _ in range(dp.world)]
    dist.all_gather(parts, flat)
    ctx["rank_weight_gap"] = max(float((p - flat).abs().max()) for p in parts)
    free_program(ctx)
    sync(dev)
    return ctx


def _rank_main(i: int, workload: dict, config: dict, seed: int, trace: bool, devices: list,
               store: str, threads: int) -> None:
    """Spawned rank i + 1: its groups on devices[i + 1]; its `--seconds` come
    from rank 0."""
    from nerf_siren_tpu_torch.parallel.multihost import local_group

    device = torch.device(devices[i + 1])
    run = Run(workload, config, seed, 0.0, trace, device, time.time())
    with local_group(device, store, len(devices), i + 1, threads, GROUP_TIMEOUT) as dp:
        rank_loop(run, dp)


def control(run) -> dict:
    """The control's readings: the reference at the configuration's
    `control_precision` on the checked global batches, put in the program's
    place, against the reference (no rank runs)."""
    ctx = checked_inputs(run, run.traffic["ranks"])
    losses, moment, mid, after = single.reference_steps(run, ctx,
                                                        run.config["control_precision"])
    ctx.update(losses=losses, moment=moment, mid=mid, after=after)
    return single.readings(run, ctx, run.config["precision"])


def run(run) -> None:
    import torch.multiprocessing as mp

    from benchmark.drivers import train_dp   # by its name, which the spawned ranks import
    from nerf_siren_tpu_torch.parallel.multihost import local_group, rank_store, rank_threads

    world, dev = run.traffic["ranks"], run.device
    devices = ([f"cuda:{dev.index + r}" for r in range(world)] if dev.type == "cuda"
               else ["cpu"] * world)
    threads = rank_threads(world)
    with rank_store() as store:
        ranks = mp.start_processes(train_dp._rank_main,
                                   args=(run.workload, run.config, run.seed, run.trace,
                                         devices, store, threads),
                                   nprocs=world - 1, join=False, start_method="spawn")
        try:
            with local_group(dev, store, world, 0, threads, GROUP_TIMEOUT) as dp:
                ctx = rank_loop(run, dp)
            while not ranks.join():
                pass
        except BaseException:   # a rank that fails leaves the others waiting in a collective
            for p in ranks.processes:
                p.terminate()
            raise
    readings = single.readings(run, ctx, run.config["precision"])
    readings["rank_weight_gap"] = ctx["rank_weight_gap"]
    run.record_checks(readings)
