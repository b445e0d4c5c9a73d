"""Grouped training steps: N steps of a system as one captured CUDA graph.

Counterpart of the JAX package's scanned programs (`lax.scan` over the pure
step in `nerf_siren_tpu/training/system.py`: `train_scan`,
`train_scan_batches`, `train_scan_importance`, `make_scan_importance`,
`make_scan_batches`). On the card a training step is mostly host launches
(hundreds of small kernels around K2), so a group of N steps is captured
once into a `torch.cuda.CUDAGraph` and then only replayed: per group the
host copies in the inputs and calls `replay()`.

A `StepGroup` owns the graph, its static inputs and the step body. Inputs
by name, each with the group's N steps stacked on the first axis:
- kind 'batches': 'rays' (N, B, 8) and 'rgbs' (N, B, 3), and for the
  semantic system 'cls' (N, B), the steps' class targets;
- kind 'pool': 'pool_rays' (P, 8), 'pool_rgbs' (P, 3) and 'idx' (N, B),
  the steps' ray indices into the pool;
- kind 'importance': the pool, 'u_cat' (N, B) uniform draws for the
  inverse-CDF pick, 'idx_uni' (N, B) uniform indices and 'take_uni'
  (N, B) bool, where the uniform floor wins;
- every kind: 'noise:<name>' for each of the steps' `StepNoise` draws
  (`render.rendering.noise_shapes`) and 'table' (N, 5), the rows of
  `Optimizer.scalar_table`.

The systems are `training/system.py::NeRFSystem` (and its semantic
subclass) and `training/eg3d_system.py::EG3DSystem`, each through the
`GroupedSteps` interface. The body, for step i: read the step's slices
(gather its rays from the pool inside the graph), run `loss_and_grads` on
the system's backend with the step's draws, apply `Optimizer.step_device`
in place, run the system's `after_update` where it has one (EG3D's `w_avg`
EMA, from the outputs of the step's forward), and write the step's loss,
PSNR and the G losses the system names in `GROUP_LOSSES` (the culled
backends' proxy loss) into row i of the (N, 2 + G) output. With
'importance' a per-ray error buffer over the pool starts at ones; each
step draws its rays with probability proportional to (err + 1e-8)^alpha by
inverse CDF (a cumulative sum and a search over the pool, not JAX's (B, P)
Gumbel slab; the sum in fixed point relative to the pool's largest
weight, exact in any order, where a card's float cumsum is not) unless
the uniform floor takes them, and writes its rays' errors back; a ray drawn twice in a step keeps the error
of its last draw (`last_occurrence`: JAX's scatter leaves that order open,
and a card's would make two runs differ). Under data
parallelism every rank holds the whole pool and its own copy of the
buffer: the step's draws are the global batch's, every rank picks the
global batch's indices and trains on its rows of them, and the rays'
errors are all-gathered (captured in the graph, as the all-reduce is) so
that every rank writes the same values in the same order.

On a CUDA device the body is captured once, after one eager forward and
backward of step 0 on a side stream (it builds K2, sets its kernels'
attributes and warms autograd; the state is not updated), and is only
replayed after that. Every tensor the body allocates comes from the
graph's private pool; only the static inputs, the output and the state's
own tensors (updated in place, so their addresses hold across replays and
an in-place checkpoint load) cross the capture. A failed capture raises:
there is no eager fallback. Under data parallelism the body's
`reduce_step` all-reduce is captured with the step (NCCL; the warm-up
makes the communicators first); a card that refuses that capture refuses
the grouped steps with an error that says so. On the CPU the same body runs as a plain loop
over the caller's tensors (`loop`), the plain version the tests hold
against N `train_step`s, and on a card against the graph.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import torch

from nerf_siren_tpu_torch.utils import tracing

NOISE = "noise:"


def importance_indices(err: torch.Tensor, u_cat: torch.Tensor, idx_uni: torch.Tensor,
                       take_uni: torch.Tensor, alpha: float) -> torch.Tensor:
    """Pool indices (B,) drawn with probability proportional to (err +
    1e-8)^alpha over the pool's errors `err` (P,), by inverse CDF on the
    uniform draws `u_cat` (B,), except where `take_uni` picks the uniform
    index `idx_uni` instead. The weights are scaled so that the largest is
    2^(62 - ceil(log2 P)), rounded and summed as int64, exactly: PyTorch's
    float cumsum on a CUDA tensor is not deterministic (the same draws could
    pick other rays in two runs), an integer one is. Only weights below
    2^-40 or so of the pool's largest round to 0."""
    n = err.shape[0]
    w = ((err + 1e-8).double() ** alpha)
    w = torch.round(w / w.max() * 2.0 ** (62 - (n - 1).bit_length())).long()
    cdf = torch.cumsum(w, 0)
    target = (u_cat.double() * cdf[-1].double()).long()
    picked = torch.searchsorted(cdf, target, right=True).clamp_max(n - 1)
    return torch.where(take_uni, idx_uni, picked)


def last_occurrence(idx: torch.Tensor, n: int) -> torch.Tensor:
    """For each entry of `idx` (B,) into n slots, the position of the last
    entry with the same index, so that duplicates all write one value
    whatever order their writes land in (static shapes: a graph takes it)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=pos.dtype, device=idx.device)
    return last.scatter_reduce_(0, idx, pos, "amax")[idx]


def _step_noise(x: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k[len(NOISE):]: v[i] for k, v in x.items() if k.startswith(NOISE)}


def _cls(x: Dict[str, torch.Tensor], i: int) -> Optional[torch.Tensor]:
    """Step i's class targets, or None."""
    return x["cls"][i] if "cls" in x else None


class StepGroup:
    """N steps of `system` on `state`'s tensors, B rays each (see the module
    docstring for the kinds and inputs)."""

    def __init__(self, system, state, kind: str, n: int, alpha: float = 1.0):
        self.system, self.state, self.kind, self.n, self.alpha = system, state, kind, n, alpha
        self.graph = None
        self.static: Dict[str, torch.Tensor] = {}
        self.out = None
        self.steps: Optional[torch.Tensor] = None   # the last run's (N, 2 + G) loss, PSNR, ...
        self.buf: Optional[torch.Tensor] = None     # 'importance': the last run's error buffer
        self.width = 2 + len(system.GROUP_LOSSES)
        self.capture_s: Optional[float] = None      # host seconds of the capture alone

    def _rays(self, x, i, buf):
        """Step i's rays and rgbs (and their pool indices, or None)."""
        if self.kind == "batches":
            return x["rays"][i], x["rgbs"][i], None
        if self.kind == "pool":
            idx = rows = x["idx"][i]
        else:   # the global batch's indices, and this rank's rows of them
            idx = rows = importance_indices(buf, x["u_cat"][i], x["idx_uni"][i],
                                            x["take_uni"][i], self.alpha)
            dp = getattr(self.system, "dp", None)
            if dp is not None:
                rows = dp.local_rows(idx, idx.shape[0] // dp.world)
        return x["pool_rays"][rows], x["pool_rgbs"][rows], idx

    def _body(self, x: Dict[str, torch.Tensor], out: torch.Tensor) -> None:
        from nerf_siren_tpu_torch.training.system import parameters

        system, state = self.system, self.state
        params = [p for _, _, p in parameters(state.models)]
        after_update = getattr(system, "after_update", None)
        dp = getattr(system, "dp", None)
        buf = None
        if self.kind == "importance":
            buf = x["buf"]
            buf.fill_(1.0)
        for i in range(self.n):
            rays, rgbs, idx = self._rays(x, i, buf)
            losses, res, grads = system.loss_and_grads(state, rays, rgbs, None,
                                                       cls_target=_cls(x, i),
                                                       noise=_step_noise(x, i))
            pred = res["rgb_fine" if "rgb_fine" in res else "rgb_coarse"].detach()
            losses, step_psnr, grads = system.reduce_step(losses, pred, rgbs, grads)
            system.optimizer.step_device(params, grads, state.opt_state, x["table"][i])
            if after_update is not None:
                after_update(state, res)
            out[i, 0] = losses["sum"].detach()
            out[i, 1] = step_psnr
            for j, name in enumerate(system.GROUP_LOSSES):
                out[i, 2 + j] = losses[name].detach()
            if buf is not None:
                err = ((pred - rgbs) ** 2).mean(dim=-1)
                if dp is not None:
                    err = dp.gather_rows(err)
                buf[idx] = err[last_occurrence(idx, buf.shape[0])]

    def _capture(self, inputs: Dict[str, torch.Tensor]) -> None:
        device = inputs["table"].device
        dp = getattr(self.system, "dp", None)
        self.static = {k: v.clone() for k, v in inputs.items()}
        if self.kind == "importance":
            self.static["buf"] = torch.ones(inputs["pool_rays"].shape[0], device=device)
        self.out = torch.zeros((self.n, self.width), device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):   # warm-up: step 0's forward and backward only
            rays, rgbs, _ = self._rays(self.static, 0, self.static.get("buf"))
            self.system.loss_and_grads(self.state, rays, rgbs, None,
                                       cls_target=_cls(self.static, 0),
                                       noise=_step_noise(self.static, 0))
            if dp is not None:   # the communicators, made before the capture
                dp.warm_up(device)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        # A dead graph (the group of an unreachable system: a group and its
        # system refer to each other) that a garbage collection frees inside
        # this capture is reset there, which the capture refuses: collect
        # now, and none during the capture.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._body(self.static, self.out)
        except RuntimeError as e:
            if dp is None:
                raise
            raise RuntimeError(
                f"grouped steps under data parallelism (world size {dp.world}) need the "
                f"card to capture the step's all-reduce into the CUDA graph, and the "
                f"capture failed: {e}. Grouped steps are refused here; run eager steps "
                f"(--steps_per_dispatch 1)") from e
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.graph = graph

    def release(self) -> None:
        """Free the captured graph and its static tensors (captured again at
        the next call)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph, self.static, self.out = None, {}, None

    def loop(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The body as a plain loop over `inputs`, uncaptured: the CPU's
        route, and on a card the plain version a graph is held against.
        Returns `steps`, the (N, 2 + G) losses and PSNRs."""
        device = inputs["table"].device
        x = dict(inputs)
        if self.kind == "importance":
            x["buf"] = self.buf = torch.ones(inputs["pool_rays"].shape[0], device=device)
        self.steps = torch.empty((self.n, self.width), device=device)
        self._body(x, self.steps)
        return self.steps

    def run(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The group's N steps on `inputs` (on the state's device): the state
        is updated in place (its counts are the caller's); returns `steps`,
        the (N, 2 + G) losses and PSNRs. On a card: the captured graph, made at
        the first call. The span `group.launch` covers the call (see
        `utils/tracing.py`); none is opened inside the captured body."""
        with tracing.span("group.launch"):
            if inputs["table"].device.type != "cuda":
                return self.loop(inputs)
            if self.graph is None:
                self._capture(inputs)
            else:
                for k, v in inputs.items():
                    self.static[k].copy_(v)
            self.graph.replay()
            self.steps = self.out.clone()
            self.buf = self.static.get("buf")
            return self.steps
