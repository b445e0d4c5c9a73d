"""Where K5's time goes: variants of csrc/triplane_gather.cu, each with one
part of the design taken out, timed in turns with `F.grid_sample` at the
EG3D path's shape on one card.

    python -m nerf_siren_tpu_torch.k5_ablation

Each variant is the source with a text edit, compiled like the kernel
(`card_bench.build_variants`) and called through the same C interface.
Every variant computes the same function, so each is also held to the
plain version (0 elements may differ). The variants:
  as built             the kernel itself;
  no load policy       table loads without the L2::evict_last policy;
  write-back stores    output stores as st.global instead of st.global.cs;
  stores not swapped   at VEC 8 each lane stores its 32 bytes as they lie
                       (two float4 stores, each filling half of every
                       sector of the warp's run);
  neither hint         both of the first two.
Points: one 4096-ray chunk of a 128² frame (the first 32 rows of the
first of `create_spheric_poses(4)`, Blender-lego camera_angle_x) at
eval_eg3d's 64 coarse depths from 0.1 to 10, 262,144 points; table: 3 x
32 planes of 256² from a numpy seed, packed to bf16 (3, 258, 258, 32);
box_warp 15. Prints, per variant, the median ms of
ROUNDS rounds (each round: F.grid_sample on the float32 planes, every
variant, then the same in reverse order; each timing REPS launches queued
behind a device-side sleep, `card_bench.device_ms`, so that host launch
time is not counted), each round's ms, the registers and spill bytes of
the VEC 8 instantiation, the ratio to F.grid_sample, and the card's name
and power limit. Needs nvcc and a card.
"""
from __future__ import annotations

import math
import re
import sys

import numpy as np
import torch
import torch.nn.functional as F

from nerf_siren_tpu_torch.card_bench import build_variants, card, device_ms, edit
from nerf_siren_tpu_torch.datasets.poses import create_spheric_poses
from nerf_siren_tpu_torch.datasets.ray_utils import get_ray_directions, get_rays
from nerf_siren_tpu_torch.ops.kernels import _build
from nerf_siren_tpu_torch.ops.kernels import triplane_gather as k5
from nerf_siren_tpu_torch.render.triplane import pack_planes_for_sampling, sample_stratified

ROUNDS, REPS = 4, 20
BOX_WARP, PLANE_RES, CHANNELS = 15.0, 256, 32
FRAME, CHUNK, DEPTHS = 128, 4096, 64
VEC8_SYMBOL = "triplane_gather_kernelI13__nv_bfloat16Li8E"   # mangled <__nv_bfloat16, 8>


def variants(src: str) -> dict:
    """{label: source text}."""
    def no_policy(text):
        text = edit(text, "ld.global.nc.L2::cache_hint.", "ld.global.nc.")
        text = re.sub(r"(\[%\d\]), %\d;\"", r'\1;"', text)
        text = edit(text, ', "l"(policy));', ");")
        return edit(text, 'asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" '
                          ': "=l"(policy));', "policy = 0;")

    def write_back(text):
        text = edit(text, "__stcs(", "store_wb(")
        return edit(text, "namespace {\n", "namespace {\n"
                    "template <typename V> __device__ void store_wb(V* p, V v) { *p = v; }\n")

    return {
        "as built": src,
        "no load policy": no_policy(src),
        "write-back stores": write_back(src),
        "stores not swapped": edit(src, "    if (full_warp) {", "    if (false) {"),
        "neither hint": write_back(no_policy(src)),
    }


def chunk_points(device) -> torch.Tensor:
    """(CHUNK * DEPTHS, 3) ray-major points of the frame's first chunk."""
    focal = 0.5 * 800 / math.tan(0.5 * 0.6911112) * FRAME / 800
    rays_o, rays_d = get_rays(get_ray_directions(FRAME, FRAME, focal),
                              create_spheric_poses(4.0, 1)[0])
    o, d = (torch.tensor(r[:CHUNK], device=device) for r in (rays_o, rays_d))
    z = sample_stratified(o[None], 0.1, 10.0, DEPTHS)[0]
    return (o[:, None] + z * d[:, None]).reshape(-1, 3).contiguous()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k5_ablation: needs a CUDA card")
    smi = card()
    dev = torch.device("cuda", 0)
    planes = np.random.default_rng(0).standard_normal((1, 3, CHANNELS, PLANE_RES, PLANE_RES),
                                                      dtype=np.float32)
    table = pack_planes_for_sampling(torch.from_numpy(planes), torch.bfloat16)[0].to(dev)
    xyz, scale = chunk_points(dev), 2.0 / BOX_WARP
    m = xyz.shape[0]
    plan = k5.launch_plan(CHANNELS, table.dtype, m, table.data_ptr())
    out = torch.empty((3, m, CHANNELS), device=dev)
    ref = k5.triplane_gather_ref(table, xyz, scale)
    planes32 = table[:, 1:-1, 1:-1, :].float().permute(0, 3, 1, 2).contiguous()
    grid = k5.project_to_planes(xyz * scale)[:, None].contiguous()

    def launcher(fn):
        def launch():
            err = fn(table.data_ptr(), 1, PLANE_RES, PLANE_RES, CHANNELS, plan.vec, xyz.data_ptr(),
                     m, scale, out.data_ptr(), plan.blocks, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"triplane_gather_forward failed: cudaError {err}")
        return launch

    src = (_build.CSRC_DIR / "triplane_gather.cu").read_text()
    built = build_variants(variants(src), "triplane_gather_forward", k5.KERNEL_ARGTYPES)
    fns = {"F.grid_sample float32": lambda: F.grid_sample(
        planes32, grid, mode="bilinear", padding_mode="zeros", align_corners=False)}
    props = {}
    for label, fn, log in built:
        fns[label] = launcher(fn)
        out.fill_(float("nan"))
        fns[label]()
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        if n_diff:
            raise RuntimeError(f"the {label!r} variant differs from the plain version in "
                               f"{n_diff} elements")
        block = log[log.index(VEC8_SYMBOL):]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        props[label] = (int(re.search(r"Used (\d+) registers", block).group(1)),
                        int(spill.group(1)) + int(spill.group(2)))
    runs = {label: [] for label in fns}
    for _ in range(ROUNDS):
        for label in list(fns) + list(fns)[::-1]:
            runs[label].append(device_ms(fns[label], REPS, queued=True))
    lib_ms = float(np.median(runs["F.grid_sample float32"]))
    for label, times in runs.items():
        med = float(np.median(times))
        extra = (f"; VEC 8 registers {props[label][0]}, spill bytes {props[label][1]}"
                 if label in props else "")
        print(f"[k5_ablation] {label:22s} {med:.4f} ms (median of {len(times)}: "
              f"{[round(t, 4) for t in times]}), / F.grid_sample {med / lib_ms:.3f}{extra}; "
              f"{m} points, {plan.load_bytes}-byte loads; {smi}", flush=True)


if __name__ == "__main__":
    main()
