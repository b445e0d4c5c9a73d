"""PSNR parity protocol: the port's renderers against a torch oracle of the
reference pipeline, on a trained scene.

Counterpart of the JAX package's `tools/psnr_parity.py`, with its flags
and defaults. BASELINE.md's bar is PSNR within ±0.1 dB of the PyTorch
reference. No real Blender/LLFF data (or reference-trained checkpoint)
ships with the repo, so the tool builds the strongest available substitute,
end to end on one device:

1. train the reference recipe (8x256 NeRF, 64 + 64 samples, lr 5e-4,
   batch 4096, `decay_step (100,)`) with `NeRFSystem` on the `jnp` backend
   (the plain PyTorch field) on 12 views of the analytic 3-sphere scene
   (`tools/scene.py`) at `--train_hw`, in groups of GROUP_STEPS pool
   steps (`train_scan`: one captured CUDA graph on a card),
2. export the trained weights as a REFERENCE-FORMAT torch checkpoint
   (`nerf_coarse.xyz_encoding_1.0.weight`, ...: the naming of reference
   utils/__init__.py:56-71), torch.save'd like a Lightning checkpoint,
3. re-import it through `tools/import_torch_ckpt.py` and load fresh fields
   from the msgpack (the round trip a reference user would run),
4. render held-out poses through (a) the torch oracle (`tools/oracle.py`,
   a full float32 render, not test_time) and (b) the port's renderers from
   the round-tripped weights: the plain `render_rays_chunked` in float32
   (`jnp_f32`) and in bf16 (`jnp_bf16`), and `render/fused.py::
   render_rays_fused` (`fused`, test_time: K1 on a card, its plain version
   on the CPU),
5. report per pose each backend's PSNR against the analytic ground truth,
   its delta against the oracle's PSNR, its agreement with the oracle
   (PSNR of one image against the other) and the seconds each render took.

The fused renderer is test_time (a sigma-only coarse pass): its FINE
output is the same math as the full render's fine pass, which the table
compares. If every |delta| is well under 0.1 dB, any PSNR the reference
would report on shared data is matched within the bar.

Run: python -m nerf_siren_tpu_torch.tools.psnr_parity [--hw 128 --poses 3
--steps 2000 --train_hw 160] [--device cpu]. Writes `--out` (default
results/psnr_parity/psnr_parity.json, beside the two checkpoints) and
prints a markdown table; on a card every row names the card and its power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from nerf_siren_tpu_torch.tools.scene import look_at, make_rays, trace_gt

BACKENDS = ("jnp_f32", "jnp_bf16", "fused")
GROUP_STEPS = 100   # training steps a group: one CUDA graph, captured once, on a card
BATCH = 4096        # rays a training step: the reference recipe's
FOCAL_800 = 0.5 * 800 / np.tan(0.5 * 0.6911112)   # the Blender camera at 800 px


def get_opts(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--poses", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--train_hw", type=int, default=160)
    ap.add_argument("--out", type=str, default="results/psnr_parity/psnr_parity.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="'cuda' (default; fails when no card is visible) or 'cpu'")
    return ap.parse_args(argv)


def export_torch_ckpt(params, path):
    """JAX-layout param trees {'coarse', 'fine'} -> reference-format
    Lightning checkpoint."""
    state = {}
    for model, name in (("coarse", "nerf_coarse"), ("fine", "nerf_fine")):
        p = params[model]

        def put(prefix, lin_p):
            state[f"{name}.{prefix}.weight"] = torch.tensor(
                np.asarray(lin_p["kernel"], np.float32).T.copy())
            state[f"{name}.{prefix}.bias"] = torch.tensor(
                np.asarray(lin_p["bias"], np.float32).copy())

        for i, layer in enumerate(p["xyz_layers"]):
            put(f"xyz_encoding_{i + 1}.0", layer)
        put("xyz_encoding_final", p["xyz_final"])
        put("sigma", p["sigma"])
        put("dir_encoding.0", p["dir_layer"])
        put("rgb.0", p["rgb"])
    torch.save({"state_dict": state}, path)


def psnr(a, b) -> float:
    return float(-10 * np.log10(np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2) + 1e-12))


def training_views(hw: int):
    """12 views around the scene at elevation 0.4 rad: (rays, rgbs) pooled."""
    focal = FOCAL_800 * hw / 800
    views = []
    for k in range(12):
        phi = 2 * np.pi * k / 12
        eye = 4.0 * np.array([np.cos(phi) * np.cos(0.4),
                              np.sin(phi) * np.cos(0.4), np.sin(0.4)])
        rays = make_rays(look_at(eye), eye, hw, hw, focal)
        views.append((rays, trace_gt(rays[:, 0:3], rays[:, 3:6])))
    return np.concatenate([v[0] for v in views]), np.concatenate([v[1] for v in views])


def held_out_pose(p: int, hw: int):
    """Pose p of the held-out set (below the training ring): (rays, gt)."""
    ang = 0.7 + 1.9 * p
    eye = 4.0 * np.array([np.cos(ang) * np.cos(-0.2),
                          np.sin(ang) * np.cos(-0.2), np.sin(-0.2)])
    rays = make_rays(look_at(eye), eye, hw, hw, FOCAL_800 * hw / 800)
    return rays, trace_gt(rays[:, 0:3], rays[:, 3:6])


def timed(fn, device: torch.device):
    """fn()'s result and its seconds (the device synchronised around it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def train(args, nerf_cfg, device: torch.device):
    """The reference recipe on the scene's 12 views: (state, train PSNR, s)."""
    from nerf_siren_tpu_torch.config import RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    all_rays, all_rgbs = training_views(args.train_hw)
    system = NeRFSystem(
        RenderConfig(n_samples=64, n_importance=64, perturb=1.0, noise_std=1.0,
                     white_back=True),
        TrainConfig(lr=5e-4, batch_size=BATCH, decay_step=(100,)),
        nerf_cfg, steps_per_epoch=args.steps, train_backend="jnp", device=device)
    state = system.init_state(0)
    t0 = time.perf_counter()
    done, m = 0, None
    while done < args.steps:
        n_chunk = min(GROUP_STEPS, args.steps - done)
        state, m = system.train_scan(state, all_rays, all_rgbs, seed=done, n_steps=n_chunk)
        done += n_chunk
    train_psnr = float(m["train/psnr"]) if m is not None else float("nan")
    return state, train_psnr, time.perf_counter() - t0


def run(args) -> Dict:
    """Train, round-trip, render and score (steps 1-5 of the module
    docstring); writes `args.out` and returns what it wrote."""
    from nerf_siren_tpu_torch import card_bench
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig
    from nerf_siren_tpu_torch.convert import nerf_to_jax
    from nerf_siren_tpu_torch.eval import resolve_device
    from nerf_siren_tpu_torch.ops.kernels.fused_mlp import pack_model_params
    from nerf_siren_tpu_torch.render.fused import render_rays_fused
    from nerf_siren_tpu_torch.render.rendering import render_rays_chunked
    from nerf_siren_tpu_torch.tools.import_torch_ckpt import import_torch_ckpt
    from nerf_siren_tpu_torch.tools.oracle import torch_render
    from nerf_siren_tpu_torch.training.checkpoints import load_nerf_fields

    device = resolve_device(args.device)
    card = card_bench.card() if device.type == "cuda" else "cpu"
    nerf_cfg = NeRFConfig()

    # ---- 1. train the reference recipe on the analytic scene --------------
    state, train_psnr, train_s = train(args, nerf_cfg, device)
    print(f"trained {args.steps} steps in {train_s:.1f} s, train psnr {train_psnr:.2f} dB "
          f"({card})", flush=True)

    # ---- 2-3. torch-format export -> importer round trip ------------------
    work = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(work, exist_ok=True)
    ref_ckpt = os.path.join(work, "parity_ref.ckpt")
    imported = os.path.join(work, "parity_imported.msgpack")
    export_torch_ckpt({k: nerf_to_jax(state.models[k].state_dict()) for k in ("coarse", "fine")},
                      ref_ckpt)
    import_torch_ckpt(ref_ckpt, imported)
    models = load_nerf_fields(imported, device, nerf_cfg=nerf_cfg)
    trees = {k: nerf_to_jax(m.state_dict()) for k, m in models.items()}
    packed = pack_model_params(models)

    # ---- 4. render held-out poses through every backend -------------------
    hw = args.hw
    # the oracle is a FULL (non-test_time) render; the plain renders match it
    jcfg = RenderConfig(n_samples=64, n_importance=64, perturb=0.0, noise_std=0.0,
                        white_back=True, test_time=False, chunk=hw * hw)
    fcfg = jcfg.replace(test_time=True)
    render = {
        "jnp_f32": lambda r: render_rays_chunked(models, r, jcfg, None),
        "jnp_bf16": lambda r: render_rays_chunked(models, r, jcfg, None,
                                                  compute_dtype=torch.bfloat16),
        "fused": lambda r: render_rays_fused(packed, r, fcfg),
    }
    rows: List[Dict] = []
    with torch.no_grad():
        for p in range(args.poses):
            rays_np, gt = held_out_pose(p, hw)
            rays = torch.from_numpy(rays_np).to(device)
            oracle, t_oracle = timed(lambda: torch_render(trees, rays, 64, 64, True)["rgb_fine"],
                                     device)
            oracle = oracle.float().cpu().numpy()
            p_oracle = psnr(oracle, gt)
            row = {"pose": p, "torch_oracle_psnr": p_oracle, "torch_oracle_s": t_oracle}
            for name in BACKENDS:
                img, sec = timed(lambda: render[name](rays)["rgb_fine"], device)
                img = img.float().cpu().numpy()
                row[f"{name}_psnr"] = psnr(img, gt)
                row[f"{name}_delta_db"] = row[f"{name}_psnr"] - p_oracle
                row[f"{name}_agreement_db"] = psnr(img, oracle)
                row[f"{name}_s"] = sec
            row["card"] = card
            rows.append(row)
            print(f"pose {p}: torch {p_oracle:.3f} dB ({t_oracle:.3f} s) | " + " | ".join(
                f"{n} Δ{row[f'{n}_delta_db']:+.4f} dB (agree {row[f'{n}_agreement_db']:.1f} "
                f"dB, {row[f'{n}_s']:.3f} s)" for n in BACKENDS) + f"; {card}", flush=True)

    result = {"hw": hw, "steps": args.steps, "train_hw": args.train_hw,
              "batch_size": BATCH, "device": str(device), "card": card,
              "train_s": train_s, "train_psnr": train_psnr, "rows": rows}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return result


def table(rows: List[Dict]) -> str:
    """The markdown table of the rows."""
    lines = ["| pose | torch PSNR | jnp f32 Δ | jnp bf16 Δ | fused Δ | f32 agree | fused agree |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['pose']} | {r['torch_oracle_psnr']:.3f} | "
                     f"{r['jnp_f32_delta_db']:+.4f} | {r['jnp_bf16_delta_db']:+.4f} | "
                     f"{r['fused_delta_db']:+.4f} | {r['jnp_f32_agreement_db']:.1f} dB | "
                     f"{r['fused_agreement_db']:.1f} dB |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> Dict:
    result = run(get_opts(argv))
    print("\n" + table(result["rows"]), flush=True)
    return result


if __name__ == "__main__":
    main()
