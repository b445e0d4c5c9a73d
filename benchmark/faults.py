"""Faults planted under the timed path, to show that the correctness check
catches them (`benchmark/tests/test_bench_faults.py` on the CPU,
`calibrate.py --fault` on the card at a cell's own size).

Each fault is a context manager that patches the port while it is open:
- `frozen_state`: the optimizer's update does nothing, so a step returns
  its state unchanged;
- `half_batch`: a training step sees only the first half of its rays, its
  mean loss taken over them (its outputs, which only the step's PSNR
  reads, the half twice);
- `stale_batch`: a group of training steps replays the rays and colours of
  the first group it ran (its draws and the optimizer's scalars fresh);
- `stale_draws`: every step of a group takes the first step's draws;
- `altered_answer`: the renderers' tiles come back with every 64th ray's
  colour moved by 0.1 (a sixty-fourth of the answers wrong);
- `frozen_distill`: the fast set-up's distillation steps leave the density
  proxy as it was initialised.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def frozen_state():
    from nerf_siren_tpu_torch.training.optimizers import Optimizer

    with patched(Optimizer, "step_device", lambda self, params, grads, state, row: None):
        yield


@contextlib.contextmanager
def half_batch():
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    def halved(cls):
        inner = cls.loss_and_grads

        def loss_and_grads(self, state, rays, rgbs, generator=None, cls_target=None,
                           noise=None):
            half = rays.shape[0] // 2
            if noise is not None:   # every draw has the rays on one axis of the batch's size
                noise = {k: _rows(v, rays.shape[0], half) for k, v in noise.items()}
            losses, out, grads = inner(self, state, rays[:half], rgbs[:half], generator,
                                       cls_target, noise)
            # the step's outputs keep the batch's shape: the half, twice
            out = {k: torch.cat([v, v]) if v.dim() and v.shape[0] == half else v
                   for k, v in out.items()}
            return losses, out, grads
        return loss_and_grads

    with patched(NeRFSystem, "loss_and_grads", halved(NeRFSystem)), \
            patched(EG3DSystem, "loss_and_grads", halved(EG3DSystem)):
        yield


@contextlib.contextmanager
def stale_batch():
    from nerf_siren_tpu_torch.training.graphs import StepGroup

    inner = StepGroup.run

    def run(self, inputs):
        first = self.__dict__.setdefault("_first_inputs", inputs)
        return inner(self, dict(inputs, **{k: first[k] for k in ("rays", "rgbs") if k in inputs}))

    with patched(StepGroup, "run", run):
        yield


@contextlib.contextmanager
def stale_draws():
    from nerf_siren_tpu_torch.training.graphs import NOISE
    from nerf_siren_tpu_torch.training.system import GroupedSteps

    inner = GroupedSteps.group_inputs

    def group_inputs(self, *args, **kwargs):
        x = inner(self, *args, **kwargs)
        return {k: v[:1].expand_as(v).contiguous() if k.startswith(NOISE) else v
                for k, v in x.items()}

    with patched(GroupedSteps, "group_inputs", group_inputs):
        yield


def _rows(v, n: int, keep: int):
    """The first `keep` of the `n` rays of a draw (rays on the first axis of
    that size, or the rays' samples flattened on the last)."""
    for axis, size in enumerate(v.shape):
        if size == n:
            return v.narrow(axis, 0, keep)
        if size % n == 0 and axis == v.dim() - 1:
            return v.narrow(axis, 0, keep * (size // n))
    return v


def _altered(inner):
    def render(*args, **kwargs):
        out = dict(inner(*args, **kwargs))
        key = next(k for k in out if k.startswith("rgb_"))
        out[key] = out[key].clone()
        out[key][::64] += 0.1
        return out
    return render


@contextlib.contextmanager
def altered_answer():
    from nerf_siren_tpu_torch import eval as port_eval

    with patched(port_eval, "render_rays_fused", _altered(port_eval.render_rays_fused)), \
            patched(port_eval, "render_rays_fast", _altered(port_eval.render_rays_fast)):
        yield


@contextlib.contextmanager
def frozen_distill():
    from nerf_siren_tpu_torch.render import fast

    with patched(fast.torch.optim.Adam, "step", lambda self, closure=None: None):
        yield


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "stale_batch": stale_batch, "stale_draws": stale_draws,
          "altered_answer": altered_answer, "frozen_distill": frozen_distill}
