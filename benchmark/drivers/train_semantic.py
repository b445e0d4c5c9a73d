"""Semantic training traffic: `train.py --mode d3`'s eager path, timed.

Set-up parses the train CLI's flags of the cell (a program whose CLI lacks
one of them stops there), makes the weights on the device from the seed
(the frozen fields of the traffic's `weights`, the point network at
PyTorch's init), the ray table of the traffic's cameras with each ray's
class target (made on the device, held on the host as a loader holds
them), and the system `train.py` builds from the flags
(`models/<model>.py`). Batches come from the port's `epoch_iterator` with
the class targets, epoch after epoch, one eager `train_step` each, as
`train.py` runs at `--steps_per_dispatch 1`.

The first `CHECKED_STEPS` steps are the ones the check compares. Before
the first, the system's own `loss_and_grads` (the call the step makes)
runs on that batch and its draws, and keeps the composited class
log-probabilities; Adam's first moment after the first step and the
point network after the last are kept. Then `warmup_steps` more, and the
window runs steps until `--seconds` have passed, ending in a synchronise:
the rate (the cell's `e2e_names`) is all the rays of the window's steps
over the window. A traced run profiles `traced_steps` steps before the
window.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the checked steps on the same
batches and draws (`readings`); the cell's `limits` name the numbers
compared. The step's model flops (`step_flops`, which `mfu_pct.train`
reads) count the point network at the valid points of the reference's
checked steps, their mean (`counts/nerf3d.py`: the fork's function; the
port's masked slots are padding). The fields are frozen, so a step's
share of valid samples stays where the checked steps put it
(`d3_valid_pct` reads it over the traced steps).
"""
from __future__ import annotations

import itertools
import time

import torch

from benchmark import compare, scenes
from benchmark.drivers.train import free_program, model_of, sync
from benchmark.harness import tf32, traced_slice

CHECKED_STEPS = 3


def prepare(run):
    """Set-up up to the checked steps: the flags, the weights, the data, the
    system and its state after those steps, and what the check keeps."""
    from nerf_siren_tpu_torch.training.system import epoch_iterator, step_generator

    cfg, tr, dev = run.config, run.traffic, run.device
    model = model_of(cfg)
    span = run.spans.span
    with span("setup.flags"):
        hparams = model.cli_options(cfg, tr)
    with span("setup.weights"):
        weights = model.make_weights(cfg, scenes.torch_generator(run.seed, dev, 0),
                                     tr["weights"])
    with span("setup.rays"):
        rays, rgbs = scenes.ray_table(tr["cameras"], run.seed, dev)
        labels = model.class_table(rays, cfg, run.seed, dev)
    b = tr["rays_per_step"]
    with span("setup.system"):
        system, state = model.train_system(hparams, cfg, weights, dev, max(1, len(rays) // b))
    batches = (batch for epoch in itertools.count()
               for batch in epoch_iterator(rays, rgbs, b, run.seed, epoch, {"cls": labels}))

    def next_batch():
        with run.spans.span("batch_prep"):
            return next(batches)

    checked, losses, first_cls, moment = [], [], None, None
    for t in range(CHECKED_STEPS):
        batch = next_batch()
        checked.append(batch)
        with span(f"setup.checked_step.{t + 1}"):
            if first_cls is None:
                noise = system.local_step_draws(step_generator(run.seed, state.step, dev), b)
                _, out, _ = system.loss_and_grads(
                    state, torch.as_tensor(batch["rays"], device=dev),
                    torch.as_tensor(batch["rgbs"], device=dev), None,
                    torch.as_tensor(batch["cls"], device=dev), noise=noise)
                first_cls = {p: out[f"cls_{p}"].detach().clone() for p in ("coarse", "fine")}
                del out
            state, metrics = system.train_step(state, batch, run.seed)
            losses.append(float(metrics[system.LOSS_KEY]))
        if moment is None:
            moment = {k: v.clone() for k, v in model.first_moments(system, state).items()}
    return dict(model=model, weights=weights, system=system, state=state,
                next_batch=next_batch, checked=checked, losses=losses, first_cls=first_cls,
                moment=moment, after=leaves(model.state_leaves(state)),
                fields_after=leaves(model.field_leaves(state)))


def leaves(tensors):
    return {k: v.detach().clone() for k, v in tensors.items()}


def reference_steps(run, ctx, precision: str):
    """The reference's steps at `precision` on the checked batches and their
    draws, from the initial weights."""
    dev, model = run.device, ctx["model"]
    batches = [(torch.as_tensor(x["rays"], device=dev), torch.as_tensor(x["rgbs"], device=dev),
                torch.as_tensor(x["cls"], device=dev)) for x in ctx["checked"]]
    with tf32(False):
        return model.REFERENCE.train_steps(
            model.reference_fields(ctx["weights"]), ctx["weights"]["points"], run.config,
            batches, run.seed, run.traffic, model.REFERENCE.operand_round(precision))


def readings(run, ctx, ref) -> dict:
    """The gaps of the program's readings (`ctx`) to the reference's
    (`ref`, `reference_steps`) on the checked steps from the initial
    weights.

    `loss_gap.<t>`: step t's relative loss gap, and `loss_gap`, the worst
    step's; `cls_gap`: the relative gap (Frobenius norms) of the first
    step's composited class log-probabilities, both passes, and
    `cls_gap.max`, the largest element's gap over the largest reference
    magnitude; `moment_gap` and `.median`: the worst and the median leaf's
    gap of norms of Adam's first moment after the first step; `change_gap` and `.median`: the worst and
    the median leaf's gap of norms of the point network's change after the
    last checked step (leaves whose reference moment is still by a
    thousandth of the median leaf's are left out). Both compare the parts
    of the point network that learn (`reference/nerf3d.py::learning`: the
    others get rounding alone, on either side); `fields_moved`: the
    largest change of a frozen field's weight (0: Adam left them as they
    were)."""
    learning = ctx["model"].REFERENCE.learning
    losses, first_cls, moment, _, after, _ = ref
    w0 = ctx["weights"]["points"]
    moment = learning(moment)
    moved = compare.moving_leaves(moment)
    got, want = (learning({k: a[k] - w0[k] for k in w0}) for a in (ctx["after"], after))
    change = compare.leaf_gaps({k: got[k] for k in moved}, {k: want[k] for k in moved})
    moments = compare.leaf_gaps(learning(ctx["moment"]), moment)
    got = torch.cat([ctx["first_cls"][p] for p in ("coarse", "fine")]).double()
    want = torch.cat([first_cls[p] for p in ("coarse", "fine")]).double()
    steps = [compare.rel_gap(a, b) for a, b in zip(ctx["losses"], losses)]
    fields0 = ctx["model"].flat_fields(ctx["weights"])
    out = {"loss_gap": max(steps),
           "cls_gap": float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)),
           "cls_gap.max": float((got - want).abs().max() / want.abs().max()),
           "moment_gap": max(moments.values()),
           "moment_gap.median": compare.median(moments.values()),
           "change_gap": max(change.values()),
           "change_gap.median": compare.median(change.values()),
           "fields_moved": max(float((ctx["fields_after"][k] - v).abs().max())
                               for k, v in fields0.items())}
    out.update({f"loss_gap.{t}": g for t, g in enumerate(steps, start=1)})
    return out


def control(run) -> dict:
    """The control's readings: the reference computed at the configuration's
    `control_precision`, put in the program's place, against the reference."""
    ctx = prepare(run)
    free_program(ctx)
    losses, first_cls, moment, _, after, _ = reference_steps(run, ctx,
                                                             run.config["control_precision"])
    ctx.update(losses=losses, first_cls=first_cls, moment=moment, after=after)
    return readings(run, ctx, reference_steps(run, ctx, run.config["precision"]))


def run(run) -> None:
    tr, dev = run.traffic, run.device
    ctx = prepare(run)
    loss_key = ctx["system"].LOSS_KEY

    def step():
        batch = ctx["next_batch"]()
        with run.spans.span("dispatch"):
            ctx["state"], metrics = ctx["system"].train_step(ctx["state"], batch, run.seed)
        return metrics[loss_key]

    with run.spans.span("setup.warmup"):
        for _ in range(tr["warmup_steps"]):
            step()
        sync(dev)
    if run.trace:
        with traced_slice(run):
            for _ in range(tr["traced_steps"]):
                step()
        run.readings["traced_steps"] = tr["traced_steps"]
    run.setup_done()
    t0 = time.perf_counter()
    losses = []
    while time.perf_counter() - t0 < run.seconds:
        losses.append(step())
    sync(dev)
    window = time.perf_counter() - t0
    run.attempted = len(losses)
    run.failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    run.e2e[run.workload["e2e_names"]["rays_per_s"]] = len(losses) * tr["rays_per_step"] / window
    run.readings.update(window_s=window, steps=len(losses), t_window=t0)
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    free_program(ctx)
    ref = reference_steps(run, ctx, run.config["precision"])
    points = sum(ref[-1]) / len(ref[-1])
    run.readings.update(points_per_step=points,
                        step_flops=ctx["model"].step_flops(run.config, tr, points))
    run.record_checks(readings(run, ctx, ref))
