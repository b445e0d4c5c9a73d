"""Where K3's time goes: variants of csrc/proxy_march.cu, each with one part
of the design taken out, timed in turns at the fast path's shape on one
card.

    python -m nerf_siren_tpu_torch.k3_ablation

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
Needs nvcc and a card.
"""
from __future__ import annotations

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
from nerf_siren_tpu_torch.render.fast import init_proxy

ROUNDS, REPS = 4, 20
FRAME, CHUNK, C, K, HIDDEN = 800, 32768, 32, 16, 96
SELECT_SYMBOL = "proxy_march_kernelILi96ELi1ELb0E"   # mangled <96, SELECT, false>
DEPTH_BARS = (5e-3, 5e-2)   # median, 99th percentile of |dz| / (far - near)
_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = [_p, _p, _p, _p, _i, _p, _ll, _i, _i, _i, _p, _p, _p, _p, _p]


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
        "no march": edit(edit(src, "= alpha_of(sc, terms_s[ray_t * 4 + 1]);", "= sc;"),
                         "march_block<EPI>(a, r0, rays_s, terms_s, rows_s, nr, tid);", ""),
        "no output stores": edit(src, "void put(float* p, float v) { *p = v; }",
                                 "void put(float* p, float v) { if (v == 1e30f) *p = v; }"),
    }


def chunk_rays(device) -> torch.Tensor:
    """(CHUNK, 8) rays drawn from an 800² lego frame, near 2, far 6."""
    focal = 0.5 * FRAME / math.tan(0.5 * 0.6911112)
    rays_o, rays_d = get_rays(get_ray_directions(FRAME, FRAME, focal),
                              create_spheric_poses(4.0, 1)[0])
    pick = np.random.default_rng(0).choice(FRAME * FRAME, CHUNK, replace=False)
    rays = np.concatenate([rays_o[pick], rays_d[pick], np.full((CHUNK, 1), 2.0),
                           np.full((CHUNK, 1), 6.0)], 1).astype(np.float32)
    return torch.from_numpy(rays).to(device)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k3_ablation: needs a CUDA card")
    smi = card()
    dev = torch.device("cuda", 0)
    pp = k3.pack_proxy_params(init_proxy(HIDDEN, generator=torch.Generator().manual_seed(0)), dev)
    rays = chunk_rays(dev)
    z = torch.empty((CHUNK, K), device=dev)
    xyz = torch.empty((CHUNK, K, 3), device=dev)
    args = k3.k3_args(pp, rays, C)

    def launcher(fn):
        def launch():
            err = fn(*args, rays.data_ptr(), CHUNK, C, K, 1, z.data_ptr(),
                     xyz.data_ptr(), None, None, torch.cuda.current_stream().cuda_stream)
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
    runs = {label: [] for label in fns}
    for _ in range(ROUNDS):
        for label in list(fns) + list(fns)[::-1]:
            runs[label].append(device_ms(fns[label], REPS))
    base = float(np.median(runs["as built"]))
    for label, times in runs.items():
        med = float(np.median(times))
        print(f"[k3_ablation] {label:16s} {med:.4f} ms (median of {len(times)}: "
              f"{[round(t, 4) for t in times]}), / as built {med / base:.3f}; registers "
              f"{props[label][0]}, spill bytes {props[label][1]}; {CHUNK} rays, C {C}, K {K}, "
              f"H {HIDDEN}; {smi}", flush=True)


if __name__ == "__main__":
    main()
