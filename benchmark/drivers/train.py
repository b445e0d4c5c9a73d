"""Training traffic: `train.py`'s grouped path, timed.

Set-up makes the weights on the device from the seed, the ray table of
the traffic's cameras (made on the device, held on the host as a
training set's loader holds it), and the port's system and state (the
configuration's `models/<model>.py`). Batches come from the port's
`epoch_iterator`, epoch after epoch; a group of `steps_per_dispatch` of
them is stacked and handed to `train_scan_batches` (one captured CUDA
graph a group on a card), as `train.py --steps_per_dispatch N` does.

The state's first two groups (`CHECKED_GROUPS`) are the ones the check
compares, and they run through the window's own call and graph: the first
captures it and replays it, the second replays it on fresh batches and
draws. Adam's first moment and the weights after the first group, and the
weights after the last, are kept. Then the graph is replayed
`warmup_groups` times, and the window runs groups until `--seconds` have
passed, ending in a synchronise: the rate (the cell's `e2e_names`) is all the rays of all the
window's steps over the window. A traced run profiles `traced_groups`
more groups before the window.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the checked steps on the same
batches and draws, and takes the first replayed step once more from the
program's weights after the first group (`readings`); the cell's `limits`
name the numbers compared.
"""
from __future__ import annotations

import gc
import importlib
import itertools
import time

import numpy as np
import torch

from benchmark import compare, scenes
from benchmark.harness import tf32, traced_slice

CHECKED_GROUPS = 2   # the graph's capture and a replay on fresh inputs


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_of(cfg: dict):
    return importlib.import_module(f"benchmark.models.{cfg['model']}")


def prepare(run):
    """Set-up up to the checked groups: the weights, the data, the system
    and its state after those groups, and what the check keeps."""
    from nerf_siren_tpu_torch.training.system import epoch_iterator

    cfg, tr, dev = run.config, run.traffic, run.device
    model = model_of(cfg)
    span = run.spans.span
    with span("setup.weights"):
        weights = model.make_weights(cfg, scenes.torch_generator(run.seed, dev, 0),
                                     tr.get("weights", "random"))
    with span("setup.rays"):
        rays, rgbs = scenes.ray_table(tr["cameras"], run.seed, dev)
    b = tr["rays_per_step"]
    with span("setup.system"):
        system, state = model.train_system(cfg, tr, weights, dev, max(1, len(rays) // b))
    batches = (batch for epoch in itertools.count()
               for batch in epoch_iterator(rays, rgbs, b, run.seed, epoch))

    def group(n):
        with run.spans.span("batch_prep"):
            bs = [next(batches) for _ in range(n)]
            return np.stack([x["rays"] for x in bs]), np.stack([x["rgbs"] for x in bs])

    checked, losses, moment, mid = [], [], None, None
    for g_k in range(CHECKED_GROUPS):
        g = group(tr["steps_per_dispatch"])
        checked += list(zip(g[0], g[1]))
        with span(f"setup.checked_group.{g_k + 1}"):
            state, _ = system.train_scan_batches(state, g[0], g[1], run.seed)
            losses += [float(v) for v in system.last_group.steps[:, 0]]
        if moment is None:
            moment = {k: v.clone() for k, v in model.first_moments(system, state).items()}
            mid = leaves(model, state)
    return dict(model=model, weights=weights, system=system, state=state, group=group,
                checked=checked, losses=losses, moment=moment, mid=mid,
                after=leaves(model, state))


def leaves(model, state):
    return {k: v.detach().clone() for k, v in model.state_leaves(state).items()}


def reference_steps(run, ctx, precision: str, start: int = 0, weights=None, n=None):
    """The reference's steps at `precision` on the checked batches from step
    `start` (their draws; from `weights`, the initial weights by default):
    (each step's loss, the first moment and the weights after one group,
    the weights after the last step)."""
    cfg, dev, model = run.config, run.device, ctx["model"]
    batches = [(torch.as_tensor(r, device=dev), torch.as_tensor(c, device=dev))
               for r, c in ctx["checked"][start:start + n if n else None]]
    with tf32(False):
        return model.REFERENCE.train_steps(
            ctx["weights"] if weights is None else weights, cfg, batches, run.seed,
            run.traffic, model.REFERENCE.operand_round(precision),
            run.traffic["steps_per_dispatch"], start=start,
            block=run.traffic.get("reference_block", 1024))


def readings(run, ctx, precision: str) -> dict:
    """The gaps of the program's readings (`ctx`) to the reference at
    `precision`: the reference follows the checked steps from the initial
    weights, and takes the first replayed step once more from the program's
    own weights after the first group.

    `loss_gap.<t>`: step t's relative loss gap, and `loss_gap`, the worst
    step's; `replay_loss_gap`: the first replayed step's loss against the
    reference's one step from the program's weights (a one-step distance
    however far two trajectories drift apart); `moment_gap` and
    `change_gap`: the worst leaf's gap of norms of Adam's first moment after
    the first group and of the change after the last step, and
    `change_gap.median`, the median leaf's (leaves the reference's moment
    leaves still by a thousandth of the median leaf's are left out of the
    change); and the configuration's own (`extra_gaps`)."""
    model = ctx["model"]
    losses, moment, _, after = reference_steps(run, ctx, precision)
    n = run.traffic["steps_per_dispatch"]
    replay = reference_steps(run, ctx, precision, start=n, weights=model.nest(ctx["mid"]),
                             n=1)[0][0]
    w0 = model.flat_weights(ctx["weights"])
    moved = compare.moving_leaves(moment)
    change = compare.leaf_gaps({k: ctx["after"][k] - w0[k] for k in moved},
                               {k: after[k] - w0[k] for k in moved})
    steps = [compare.rel_gap(a, b) for a, b in zip(ctx["losses"], losses)]
    out = {"loss_gap": max(steps),
           "replay_loss_gap": compare.rel_gap(ctx["losses"][n], replay),
           "moment_gap": max(compare.leaf_gaps(ctx["moment"], moment).values()),
           "change_gap": max(change.values()),
           "change_gap.median": compare.median(change.values())}
    out.update({f"loss_gap.{t}": g for t, g in enumerate(steps, start=1)})
    if hasattr(model, "extra_gaps"):
        out.update(model.extra_gaps(ctx["after"], after, w0))
    return out


def control(run) -> dict:
    """The control's readings: the reference computed at the configuration's
    `control_precision` (the precision below the one it states), put in the
    program's place, against the reference."""
    ctx = prepare(run)
    free_program(ctx)
    losses, moment, mid, after = reference_steps(run, ctx, run.config["control_precision"])
    ctx.update(losses=losses, moment=moment, mid=mid, after=after)
    return readings(run, ctx, run.config["precision"])


def free_program(ctx) -> None:
    for k in ("system", "state", "group"):
        ctx.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(run) -> None:
    tr, dev = run.traffic, run.device
    ctx = prepare(run)
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
    if run.trace:
        with traced_slice(run):
            for _ in range(tr["traced_groups"]):
                step_group()
        run.readings["traced_steps"] = tr["traced_groups"] * n
    run.setup_done()
    t0 = time.perf_counter()
    group_losses = []
    while time.perf_counter() - t0 < run.seconds:
        group_losses.append(step_group()[loss_key])
    sync(dev)
    window = time.perf_counter() - t0
    steps = len(group_losses) * n
    run.attempted = steps
    run.failed = n * int((~torch.isfinite(torch.stack(group_losses))).sum()) if steps else 0
    run.e2e[run.workload["e2e_names"]["rays_per_s"]] = steps * tr["rays_per_step"] / window
    run.readings.update(window_s=window, steps=steps, t_window=t0,
                        step_flops=ctx["model"].step_flops(run.config, tr))
    k_flops, k_bytes = ctx["model"].kernel_step_work(run.config, tr)
    run.readings.update(kernel_step_flops=k_flops, kernel_step_bytes=k_bytes)
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    free_program(ctx)
    run.record_checks(readings(run, ctx, run.config["precision"]))
