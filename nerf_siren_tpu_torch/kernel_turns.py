"""K1-K4 and K6 of this tree and another in turns, on one card, through
`chip_smoke.py`'s own readings and the kernels' device times.

    python -m nerf_siren_tpu_torch.kernel_turns <other tree> [--rounds 2]

`<other tree>` is a checkout of the repository (for example a `git archive`
of an earlier commit). Each round runs four fresh processes, before, after,
after, before: "before" in the other tree's root on its own package,
kernels and `chip_smoke.py`, "after" in this one's. Each process builds K1
and K2, then takes the smoke's readings on its seeded fields and rays:
phase 3's K1 (`check_kernels`: the sigma pass at 32,768 rays x 64 points,
the full pass at 32,768 x 192, each in turns with its plain version) and
phase 23's K2 at the culled step's shape (`check_culled_kernels`: forward
and backward over the coarse and the fine field at 1024 rays x 24
points). Those readings are CUDA events around back-to-back wrapper
calls, so a call shorter on the card than on the host reads the host's
launch cost. Each process therefore also takes the same work's device
time alone (`card_bench.kernel_ms`, the profiler's kernels): the full
pass at its shape and K2 at the culled shape on inputs made as phase 23
makes them, and the proxy and int8 kernels at phase 8's shapes on the
lego frame's rays with a seeded proxy (hidden 96): K3 select at one chunk
(C 32, K 16), K3 opacity over the frame (C 16), K6 at 65,536 rays (C 64,
K 16), K4's sigma pass at the chunk's 64 coarse points a ray and its full
pass at 16 survivors a ray. Then it reads the card's SM clock, temperature
and power draw. Prints each turn's ms per reading, the medians per tree, and the
card's name and power limit. Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

READINGS = ("fused_nerf_sigma", "fused_nerf_full", "fused_train_fwd", "fused_train_bwd",
            "device fused_nerf_full", "device fused_train_fwd", "device fused_train_bwd",
            "device proxy_march_select", "device proxy_opacity", "device proxy_select",
            "device fused_nerf_sigma_int8", "device fused_nerf_full_int8")

# One process's readings, in the root of the tree it measures; only the
# smoke's functions that both trees share.
CHILD = r"""
import concurrent.futures, json, subprocess, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from nerf_siren_tpu_torch.card_bench import card, kernel_ms
from nerf_siren_tpu_torch.ops.kernels import _build
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6
from nerf_siren_tpu_torch.render.fast import init_proxy

sources = ("fused_mlp", "fused_mlp_train", "proxy_march", "fused_mlp_int8")
with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
    list(pool.map(_build.build, sources))
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
smi = card()
models = cs.numpy_models(cs.SEED, dev)
packed = fm.pack_model_params(models)["fine"]
rays = cs.lego_rays(0, dev)
ms = {k: v["ms"] for k, v in {**cs.check_kernels(packed, dev, smi),
                              **cs.check_culled_kernels(models, rays, dev, smi)}.items()}

def device(fn):
    return sum(kernel_ms(fn, 5).values())

gen = torch.Generator(device=dev).manual_seed(1)
r = rays[torch.randint(0, rays.shape[0], (cs.CHUNK,), generator=gen, device=dev)]
s = cs.N_SAMPLES + cs.N_IMPORTANCE
z = torch.linspace(cs.NEAR, cs.FAR, s, device=dev)
pts = (r[:, None, :3] + r[:, None, 3:6] * z[:, None]).reshape(-1, 3)
d = r[:, 3:6].contiguous()
ms["device fused_nerf_full"] = device(lambda: fm.fused_nerf_full(packed, pts, d, s))
r = rays[torch.randint(0, rays.shape[0], (cs.TRAIN_RAYS,), generator=gen, device=dev)]
s = cs.CULLED_K
z = torch.sort(r[:, 6:7] + (r[:, 7:8] - r[:, 6:7])
               * torch.rand((cs.TRAIN_RAYS, s), generator=gen, device=dev), -1)[0]
pts = (r[:, None, :3] + r[:, None, 3:6] * z[..., None]).reshape(-1, 3).contiguous()
d = r[:, 3:6].contiguous()
dy = torch.rand((pts.shape[0], 4), generator=gen, device=dev) * 2.0 - 0.5
packs = [k2.pack_train_params(models[k].state_dict()) for k in ("coarse", "fine")]
ms["device fused_train_fwd"] = device(lambda: [k2.fused_train_fwd(p, pts, d, s) for p in packs])
ms["device fused_train_bwd"] = device(lambda: [k2.fused_train_bwd(p, pts, d, dy, s)
                                               for p in packs])
pp = k3.pack_proxy_params(init_proxy(96, generator=torch.Generator().manual_seed(1)), dev)
chunk = rays[torch.randint(0, rays.shape[0], (cs.CHUNK,), generator=gen, device=dev)]
ms["device proxy_march_select"] = device(
    lambda: k3.proxy_march_select(pp, chunk, cs.FAST_C, cs.FAST_K, midpoint=True))
ms["device proxy_opacity"] = device(lambda: k3.proxy_opacity(pp, rays, cs.PREPASS_C))
ms["device proxy_select"] = device(lambda: k6.proxy_select(pp, rays[:cs.K6_RAYS], cs.K6_C,
                                                            cs.K6_K))
p8 = k4.pack_nerf_params_int8(models["fine"])
z = torch.linspace(cs.NEAR, cs.FAR, cs.N_SAMPLES, device=dev)
coarse = (chunk[:, None, :3] + chunk[:, None, 3:6] * z[:, None]).reshape(-1, 3)
z = torch.linspace(cs.NEAR, cs.FAR, cs.FAST_K, device=dev)
surv = (chunk[:, None, :3] + chunk[:, None, 3:6] * z[:, None]).reshape(-1, 3)
d = chunk[:, 3:6].contiguous()
ms["device fused_nerf_sigma_int8"] = device(lambda: k4.fused_nerf_sigma_int8(p8, coarse))
ms["device fused_nerf_full_int8"] = device(lambda: k4.fused_nerf_full_int8(p8, surv, d,
                                                                           cs.FAST_K))
after = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60).stdout.strip()
print(json.dumps({"ms": ms, "after": after}))
"""


def turn(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"the readings in {tree} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="the other tree's root (\"before\")")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch
    from nerf_siren_tpu_torch.card_bench import card

    if not torch.cuda.is_available():
        sys.exit("kernel_turns: needs a CUDA card")
    smi = card()
    trees = {"before": args.other.resolve(), "after": Path(__file__).resolve().parents[1]}
    runs = {"before": [], "after": []}
    for _ in range(args.rounds):
        for label in ("before", "after", "after", "before"):
            r = turn(trees[label])
            runs[label].append(r)
            print(f"[kernel_turns] {label}: "
                  + ", ".join(f"{w} {r['ms'][w]:.4f}" for w in READINGS)
                  + f" ms; after it SM clock, temperature, power: {r['after']}; {smi}",
                  flush=True)
    for label, rs in runs.items():
        print(f"[kernel_turns] {label} ({trees[label]}): "
              + "; ".join(f"{w} {[round(r['ms'][w], 4) for r in rs]} (median "
                          f"{float(np.median([r['ms'][w] for r in rs])):.4f})"
                          for w in READINGS) + f" ms; {smi}", flush=True)


if __name__ == "__main__":
    main()
