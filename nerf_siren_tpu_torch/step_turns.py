"""The `fused` training step of this tree and another in turns, on one card.

    python -m nerf_siren_tpu_torch.step_turns <other tree> [--rounds 1]

`<other tree>` is a checkout of the repository (for example a `git archive`
of an earlier commit). Each round runs four fresh processes, before, after,
after, before: "before" in the other tree's root on its own package and
kernels, "after" in this one's. Each process takes STEPS steps of
`NeRFSystem.train_step` on the `fused` backend at opt.py's defaults (1024
rays, 64 + 128 samples, perturb 1, noise_std 1, Adam 5e-4) from
torch-seeded fields, on rays drawn around the Blender box from a numpy
seed with random targets (the step's cost does not depend on them), and
prints the median host ms per step after WARMUP steps; then PROFILED more
steps under `torch.profiler`: the device's busy ms per step (the union of
the kernels' intervals), K2's forward's device ms per step (kernels named
`nerf_train_fwd*`) and the idle share. Prints each turn, the medians per
tree, and the card's name and power limit. Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

STEPS, WARMUP, PROFILED = 40, 10, 3

# One process's measurement, in the root of the tree it measures; only
# package interfaces that both trees share.
CHILD = r"""
import json, math, sys, time
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.training.system import NeRFSystem

steps, warmup, profiled = map(int, sys.argv[1:4])
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
rng = np.random.default_rng(0)
n = 65536
eye = rng.normal(size=(n, 3))
eye[:, 2] = np.abs(eye[:, 2])
eye = 4.0 * eye / np.linalg.norm(eye, axis=-1, keepdims=True)
d = -eye / 4.0 + 0.3 * rng.normal(size=(n, 3))
d /= np.linalg.norm(d, axis=-1, keepdims=True)
rays = torch.tensor(np.concatenate([eye, d, np.full((n, 1), 2.0), np.full((n, 1), 6.0)], 1),
                    dtype=torch.float32, device=dev)
rgbs = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32, device=dev)
system = NeRFSystem(RenderConfig(n_samples=64, n_importance=128, perturb=1.0, noise_std=1.0,
                                 white_back=True),
                    TrainConfig(lr=5e-4, decay_step=(20,), decay_gamma=0.1, batch_size=1024),
                    NeRFConfig(), n // 1024, train_backend="fused", device=dev)
state = system.init_state(0)
picks = [torch.as_tensor(rng.integers(0, n, 1024), device=dev) for _ in range(steps + profiled)]
batches = [{"rays": rays[i], "rgbs": rgbs[i]} for i in picks]
times = []
for b in batches[:steps]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = system.train_step(state, b, seed=1)
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for b in batches[steps:]:
        state, _ = system.train_step(state, b, seed=1)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
busy, end = 0.0, -math.inf
for e in kernels:
    busy += max(0.0, e.time_range.end - max(e.time_range.start, end)) / 1e3
    end = max(end, e.time_range.end)
fwd = sum(e.time_range.elapsed_us() for e in kernels if "nerf_train_fwd" in e.name) / 1e3
print(json.dumps({"step_ms": float(np.median(times[warmup:])), "busy_ms": busy / profiled,
                  "fwd_ms": fwd / profiled, "idle": 1 - busy / wall}))
"""


def turn(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(STEPS), str(WARMUP), str(PROFILED)],
                          cwd=tree, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"the step in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other tree's root (\"before\")")
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args()
    import torch
    from nerf_siren_tpu_torch.card_bench import card

    if not torch.cuda.is_available():
        sys.exit("step_turns: needs a CUDA card")
    smi = card()
    trees = {"before": args.other.resolve(), "after": Path(__file__).resolve().parents[1]}
    runs = {"before": [], "after": []}
    for _ in range(args.rounds):
        for label in ("before", "after", "after", "before"):
            r = turn(trees[label])
            runs[label].append(r)
            print(f"[step_turns] {label}: step {r['step_ms']:.3f} ms (median of "
                  f"{STEPS - WARMUP}), profiled busy {r['busy_ms']:.3f} ms a step, K2 forward "
                  f"{r['fwd_ms']:.3f} ms a step, idle {100 * r['idle']:.2f}%; {smi}", flush=True)
    for label, rs in runs.items():
        print(f"[step_turns] {label} ({trees[label]}): step medians "
              f"{[round(r['step_ms'], 3) for r in rs]} ms, their median "
              f"{float(np.median([r['step_ms'] for r in rs])):.3f}; busy "
              f"{[round(r['busy_ms'], 3) for r in rs]}; K2 forward "
              f"{[round(r['fwd_ms'], 3) for r in rs]}; {smi}", flush=True)


if __name__ == "__main__":
    main()
