"""Where K3's and K6's time goes: variants of csrc/proxy_march.cu, each with
one part of the design taken out, timed in turns on one card.

    python -m nerf_siren_tpu_torch.k3_ablation
    python -m nerf_siren_tpu_torch.k3_ablation --k6

Each variant is the source with a text edit, compiled like the kernel
(`card_bench.build_variants`) and called through the same C interface,
`proxy_march_select_forward`. The variants:
  as built          the kernel itself;
  no sincosf        the embedding from the coordinates alone (each angle's
                    sin and cos replaced by the scaled coordinate);
  no products       no wgmma: each product's A fragments are folded into
                    its accumulators with one add per k-step, so the
                    embedding and the hidden activations are still built;
  no march          the scores only: no alpha, scan, CDF or placement (the
                    epilogue stores the scores, which nothing reads);
  no output stores  every output store behind a test that never passes
                    (the samples are placed, never stored).
Rays: one 32,768-ray chunk drawn with a numpy seed from an 800² frame of
the Blender-lego camera (`create_spheric_poses`, camera_angle_x 0.6911112),
near 2, far 6; C 32, K 16, midpoint, no density: the eval CLI's fast
defaults. Proxy: hidden 96 from a torch seed (`init_proxy`). Prints, per
variant, the median ms of ROUNDS rounds (each round: every variant, then
the same in reverse order; each timing REPS launches, `card_bench.
device_ms`), each round's ms, its ratio to the kernel as built, the
registers and spill bytes of the select instantiation at width 96, and the
card's name and power limit. The kernel as built is also held to the plain
version on these rays (the depths' bars of tests/test_proxy_march.py).

With --k6, the top-K (K6, the kernel's TOPK epilogue) at chip_smoke.py
phase 8's shape: K6_RAYS rays drawn the same way, C 64, K 16, hidden 96,
through `proxy_select_forward`. Its variants (`k6_variants`): as built;
no sincosf and no products (the same edits, in the scoring stage the two
kernels share); one rank a thread (each thread of the top-K ranks one
candidate at a time, RANK_P = 1, in place of four); no top-K (the scores
stored in shared memory and nothing selected). The kernel as built is
held to its contract on these rays: its scores within `proxy_score_bar`
of the plain ones, the plain selection on them equal to its depths bit
for bit, and every set that differs from the plain one a near tie.
Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import sys

import numpy as np
import torch

from nerf_siren_tpu_torch.card_bench import build_variants, card, device_ms, edit, ptxas_props
from nerf_siren_tpu_torch.datasets.poses import create_spheric_poses
from nerf_siren_tpu_torch.datasets.ray_utils import get_ray_directions, get_rays
from nerf_siren_tpu_torch.ops.kernels import _build
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6
from nerf_siren_tpu_torch.render.fast import init_proxy

ROUNDS, REPS = 4, 20
FRAME, CHUNK, C, K, HIDDEN = 800, 32768, 32, 16, 96
SELECT_SYMBOL = "proxy_march_kernelILi96ELi1ELb0E"   # mangled <96, SELECT, false>
DEPTH_BARS = (5e-3, 5e-2)   # median, 99th percentile of |dz| / (far - near)
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = [_p, _p, _p, _p, _i, _p, _ll, _i, _i, _i, _p, _p, _p, _p, _p, _ll, _p]
K6_RAYS, K6_C, K6_K = 65_536, 64, 16
TOPK_SYMBOL = "proxy_march_kernelILi96ELi2ELb0E"     # mangled <96, TOPK, false>
K6_ARGTYPES = [_p, _p, _p, _p, _i, _p, _ll, _i, _i, _p, _p, _ll, _p]


def variants(src: str) -> dict:
    """{label: source text}."""
    return {
        "as built": src,
        "no sincosf": edit(src, "sincosf(v * __int_as_float((127 + k) << 23), &s, &c);",
                           "s = c = v * __int_as_float((127 + k) << 23);"),
        "no products": edit(edit(
            src, "sm90::wgmma_rs<NT>(acc, frag[s], sm90::desc_sw128(w1t_addr + 32 * s), s > 0);",
            "acc[s] += __uint_as_float(frag[s][0] ^ frag[s][1] ^ frag[s][2] ^ frag[s][3]);"),
            "sm90::wgmma_rs<8>(acc2, hfrag[s],",
            "acc2[0] += __uint_as_float(hfrag[s][0] ^ hfrag[s][1] ^ hfrag[s][2] ^ hfrag[s][3]),"
            " (void)(acc2, hfrag[s],"),
        "no march": edit(edit(edit(src, "= alpha_of(sc, terms_s[ray_t * 4 + 1]);", "= sc;"),
                              "march_block<EPI>(a, r0, rays_s, terms_s, rows_s, nr, tid);", ""),
                         "march_block<EPI>(a, r0, rays_s, terms_s, row, 1, tid);", ""),
        "no output stores": edit(src, "void put(float* p, float v) { *p = v; }",
                                 "void put(float* p, float v) { if (v == 1e30f) *p = v; }"),
    }


def k6_variants(src: str) -> dict:
    """{label: source text} of the top-K's variants."""
    shared = variants(src)
    return {"as built": src, "no sincosf": shared["no sincosf"],
            "no products": shared["no products"],
            "one rank a thread": edit(src, "int RANK_P = 4;", "int RANK_P = 1;"),
            "no top-K": edit(src, "topk_block(a, r0, rays_s, rows_s, nr, tid);", "")}


def chunk_rays(device, n: int = CHUNK) -> torch.Tensor:
    """(n, 8) rays drawn from an 800² lego frame, near 2, far 6."""
    focal = 0.5 * FRAME / math.tan(0.5 * 0.6911112)
    rays_o, rays_d = get_rays(get_ray_directions(FRAME, FRAME, focal),
                              create_spheric_poses(4.0, 1)[0])
    pick = np.random.default_rng(0).choice(FRAME * FRAME, n, replace=False)
    rays = np.concatenate([rays_o[pick], rays_d[pick], np.full((n, 1), 2.0),
                           np.full((n, 1), 6.0)], 1).astype(np.float32)
    return torch.from_numpy(rays).to(device)


def in_turns(fns: dict) -> dict:
    """{label: ms of each timing}: ROUNDS rounds, each every function in
    order, then in reverse."""
    runs = {label: [] for label in fns}
    for _ in range(ROUNDS):
        for label in list(fns) + list(fns)[::-1]:
            runs[label].append(device_ms(fns[label], REPS))
    return runs


def report(runs: dict, props: dict, shape: str, smi: str) -> None:
    base = float(np.median(runs["as built"]))
    for label, times in runs.items():
        med = float(np.median(times))
        print(f"[k3_ablation] {label:16s} {med:.4f} ms (median of {len(times)}: "
              f"{[round(t, 4) for t in times]}), / as built {med / base:.3f}; registers "
              f"{props[label][0]}, spill bytes {props[label][1]}; {shape}; {smi}", flush=True)


def k6_main() -> None:
    smi = card()
    dev = torch.device("cuda", 0)
    pp = k3.pack_proxy_params(init_proxy(HIDDEN, generator=torch.Generator().manual_seed(0)), dev)
    rays = chunk_rays(dev, K6_RAYS)
    z = torch.empty((K6_RAYS, K6_K), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = k3.k3_args(pp, rays)

    def launcher(fn):
        def launch():
            err = fn(*args, rays.data_ptr(), K6_RAYS, K6_C, K6_K, z.data_ptr(), None, 0, stream)
            if err:
                raise RuntimeError(f"proxy_select_forward failed: cudaError {err}")
        return launch

    texts = k6_variants((_build.CSRC_DIR / "proxy_march.cu").read_text())
    fns, props = {}, {}
    for label, fn, log in build_variants(texts, "proxy_select_forward", K6_ARGTYPES):
        fns[label] = launcher(fn)
        props[label] = next(v for k, v in ptxas_props(log).items() if TOPK_SYMBOL in k)[:2]

    # the kernel as built: its scores within the bar, the plain selection on them its depths
    scores, kz = k6.proxy_select_scores(pp, rays, K6_C, K6_K)
    fns["as built"]()
    torch.cuda.synchronize()
    zc = k6.candidate_depths(rays, K6_C)
    pts = rays[:, None, 0:3] + rays[:, None, 3:6] * zc[..., None]
    ref, bar = k3.proxy_scores_ref(pp, pts), k3.proxy_score_bar(pp, pts)
    within = bool(((scores - ref).abs() <= bar).all())
    same = torch.equal(z, kz) and torch.equal(z, k6.proxy_select_ref(pp, rays, K6_C, K6_K,
                                                                     scores=scores))
    n_sets, worst = k6.cut_swaps(ref, bar, scores, K6_K)
    print(f"[k3_ablation] K6 as built at {K6_RAYS} rays: scores within proxy_score_bar "
          f"{within}; the plain selection on its scores {'bit-equal' if same else 'DIFFERENT'}; "
          f"{n_sets} rays keep another set than the plain version, worst swap / bars {worst:.3e}",
          flush=True)
    if not (within and same and worst <= 1.0):
        raise RuntimeError("K6 as built breaks its contract")
    report(in_turns(fns), props, f"{K6_RAYS} rays, C {K6_C}, K {K6_K}, H {HIDDEN}", smi)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--k6", action="store_true", help="the top-K (K6) and its variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k3_ablation: needs a CUDA card")
    if args.k6:
        k6_main()
        return
    smi = card()
    dev = torch.device("cuda", 0)
    pp = k3.pack_proxy_params(init_proxy(HIDDEN, generator=torch.Generator().manual_seed(0)), dev)
    rays = chunk_rays(dev)
    z = torch.empty((CHUNK, K), device=dev)
    xyz = torch.empty((CHUNK, K, 3), device=dev)
    args = k3.k3_args(pp, rays)

    def launcher(fn):
        def launch():
            err = fn(*args, rays.data_ptr(), CHUNK, C, K, 1, z.data_ptr(),
                     xyz.data_ptr(), None, None, None, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"proxy_march_select_forward failed: cudaError {err}")
        return launch

    src = (_build.CSRC_DIR / "proxy_march.cu").read_text()
    built = build_variants(variants(src), "proxy_march_select_forward", ARGTYPES)
    fns, props = {}, {}
    for label, fn, log in built:
        fns[label] = launcher(fn)
        props[label] = next(v for k, v in ptxas_props(log).items() if SELECT_SYMBOL in k)[:2]
    rz = k3.proxy_march_select_ref(pp, rays, C, K, True)[0]
    fns["as built"]()
    torch.cuda.synchronize()
    dz = (z - rz).abs() / (rays[:, 7:8] - rays[:, 6:7])
    med, p99 = float(dz.median()), float(torch.quantile(dz.flatten(), 0.99))
    print(f"[k3_ablation] as built vs plain at {CHUNK} rays: depth |d|/(far-near) median "
          f"{med:.3e}, 99th pct {p99:.3e} (bars {DEPTH_BARS})", flush=True)
    if not (med < DEPTH_BARS[0] and p99 < DEPTH_BARS[1]):
        raise RuntimeError("the kernel as built disagrees with its plain version")
    report(in_turns(fns), props, f"{CHUNK} rays, C {C}, K {K}, H {HIDDEN}", smi)


if __name__ == "__main__":
    main()
