#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Run from the repository root. Phases, each printing a line:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: compiles the hand-written kernels from csrc/ (seconds printed).
  3. kernels vs plain: full-width 8x256 NeRF weights from a numpy seed,
     through convert.py and the kernel pack; each kernel against its plain
     PyTorch version at N = 1,000,003 points in the Blender box (|x| <= 4),
     max |delta| <= 2e-3 + 1e-2 |ref| (bf16 operands and float32
     accumulation on both sides, only the summation order differs); then
     the same check and each kernel's time beside the plain version's at the
     eval path's shapes (32768 rays x 64 sigma points; 32768 x 192 full
     points, one direction per ray).
  4. main path: 3 Blender-lego 800x800 frames (64 + 128 samples, chunk
     32768, white background) through the port eval's `make_renderer` with
     the fused renderer; checks finite outputs, rgb in [0, 1 + 1e-3], each
     kernel launched at least chunks x frames times, and 2048 rays of the
     first frame against a CPU re-render on the plain field (atol 5e-3).
  With `--profile`, one more frame under `torch.profiler`: device time per
  kernel, the device's idle share of the frame and the peak device memory.
Then one JSON line of kernels, the nvidia-smi line, and the JSON result as
the last line. Any failure exits non-zero before the result is printed.
"""
import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
H = W = 800
FOCAL = 0.5 * 800 / math.tan(0.5 * 0.6911112)   # Blender lego camera_angle_x
RADIUS, NEAR, FAR = 4.0, 2.0, 6.0
N_FRAMES, N_SAMPLES, N_IMPORTANCE, CHUNK = 3, 64, 128, 32768
N_CHECK = 1_000_003
KERNEL_TOL = (2e-3, 1e-2)    # atol, rtol
RENDER_ATOL = 5e-3
CHECK_RAYS = slice(400 * W, 400 * W + 2048)   # rays through the image centre rows
KERNELS = {   # wrapper name -> (launch counter key, TPU kernel it replaces)
    "fused_nerf_sigma": ("sigma", "nerf_siren_tpu/ops/pallas/fused_mlp.py:262"),
    "fused_nerf_full": ("full", "nerf_siren_tpu/ops/pallas/fused_mlp.py:272"),
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def numpy_nerf_params(rng, cfg):
    """A JAX-layout NeRF tree (kernel (in, out)) with the torch-default
    U(-1/sqrt(in), 1/sqrt(in)) init, as `init_nerf` builds it."""
    def lin(i, o):
        b = 1.0 / math.sqrt(i)
        return {"kernel": rng.uniform(-b, b, (i, o)).astype(np.float32),
                "bias": rng.uniform(-b, b, (o,)).astype(np.float32)}

    layers = []
    for i in range(cfg.depth):
        in_dim = (cfg.in_channels_xyz if i == 0 else
                  cfg.width + cfg.in_channels_xyz if i in cfg.skips else cfg.width)
        layers.append(lin(in_dim, cfg.width))
    return {"xyz_layers": layers, "xyz_final": lin(cfg.width, cfg.width),
            "sigma": lin(cfg.width, 1),
            "dir_layer": lin(cfg.width + cfg.in_channels_dir, cfg.width // 2),
            "rgb": lin(cfg.width // 2, 3)}


def make_models(device):
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF

    rng = np.random.default_rng(SEED)
    models = {}
    for name in ("coarse", "fine"):
        model = NeRF(NeRFConfig())
        model.load_state_dict(nerf_from_jax(numpy_nerf_params(rng, model.cfg)))
        models[name] = model.to(device)
    return models


def lego_rays(k, device, h=H, w=W):
    """(h*w, 8) rays of camera k of N_FRAMES on the radius-4 sphere, looking
    at the origin (OpenGL camera, -z forward), near 2, far 6."""
    import torch

    theta, phi = 2 * math.pi * k / N_FRAMES, math.radians(30.0)
    eye = RADIUS * np.array([math.cos(phi) * math.cos(theta),
                             math.cos(phi) * math.sin(theta), math.sin(phi)])
    z = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    c2w = torch.tensor(np.stack([x, np.cross(z, x), z], 1), dtype=torch.float32, device=device)
    f = FOCAL * w / 800
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    dirs = torch.stack([(i - w / 2) / f, -(j - h / 2) / f, -torch.ones_like(i)], -1)
    dirs = dirs.reshape(-1, 3) @ c2w.T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    n = dirs.shape[0]
    origin = torch.tensor(eye, dtype=torch.float32, device=device).expand(n, 3)
    return torch.cat([origin, dirs, torch.full((n, 1), NEAR, device=device),
                      torch.full((n, 1), FAR, device=device)], -1).contiguous()


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, ref, where):
    """Max |got - ref|; fails on a shape mismatch, a non-finite value or any
    element outside KERNEL_TOL."""
    import torch

    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"{name} {where}: shape {tuple(got.shape)} vs {tuple(ref.shape)} "
             f"or non-finite output")
    atol, rtol = KERNEL_TOL
    delta = (got - ref).abs()
    bad = int((delta > atol + rtol * ref.abs()).sum())
    err = float(delta.max())
    print(f"[3/4] {name} vs plain {where}: max|d| {err:.3e} "
          f"(per column {[f'{v:.2e}' for v in delta.amax(0).tolist()]}), "
          f"{bad} outside {atol} + {rtol}|ref|", flush=True)
    if bad:
        fail(f"{name} disagrees with its plain version {where}")
    return err


def check_kernels(packed, device):
    """Phase 3: each kernel against its plain version at N_CHECK points and
    at the eval path's shapes, then both timed at the latter."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm

    rng = np.random.default_rng(SEED + 1)
    xyz = torch.tensor(rng.uniform(-4.0, 4.0, (N_CHECK, 3)), dtype=torch.float32, device=device)
    d = torch.tensor(rng.normal(size=(N_CHECK, 3)), dtype=torch.float32, device=device)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    where = f"at N={N_CHECK}"
    errs = {"fused_nerf_sigma": compare("fused_nerf_sigma", fm.fused_nerf_sigma(packed, xyz),
                                        fm.fused_sigma_ref(packed, xyz), where),
            "fused_nerf_full": compare("fused_nerf_full", fm.fused_nerf_full(packed, xyz, d),
                                       fm.fused_full_ref(packed, xyz, d), where)}
    del xyz, d

    # the eval path's shapes: one chunk of rays drawn at random from a whole
    # frame (so neighbouring rays differ in direction), 64 sigma points and
    # 192 full points per ray, one direction per ray
    pick = torch.as_tensor(rng.permutation(H * W)[:CHUNK], device=device)
    rays = lego_rays(0, device)[pick]
    s_all = N_SAMPLES + N_IMPORTANCE
    zc = torch.linspace(NEAR, FAR, N_SAMPLES, device=device)
    zf = torch.linspace(NEAR, FAR, s_all, device=device)
    pts_c = (rays[:, None, :3] + rays[:, None, 3:6] * zc[:, None]).reshape(-1, 3)
    pts_f = (rays[:, None, :3] + rays[:, None, 3:6] * zf[:, None]).reshape(-1, 3)
    dirs = rays[:, 3:6].contiguous()
    results = {}
    for name, kern, plain, n_pts, where in (
            ("fused_nerf_sigma", lambda: fm.fused_nerf_sigma(packed, pts_c),
             lambda: fm.fused_sigma_ref(packed, pts_c), pts_c.shape[0],
             f"at {CHUNK} rays x {N_SAMPLES}"),
            ("fused_nerf_full", lambda: fm.fused_nerf_full(packed, pts_f, dirs, s_all),
             lambda: fm.fused_full_ref(packed, pts_f, dirs, s_all), pts_f.shape[0],
             f"at {CHUNK} rays x {s_all}, samples_per_dir {s_all}")):
        err = max(errs[name], compare(name, kern(), plain(), where))
        # timing, in turns: plain, kernel, kernel, plain
        p1, k1, k2, p2 = (cuda_ms(plain, 3), cuda_ms(kern, 5), cuda_ms(kern, 5),
                          cuda_ms(plain, 3))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        tflops = n_pts * 1e-12 * _flop_per_point(packed, name == "fused_nerf_full") / (ms * 1e-3)
        print(f"[3/4] {name} at {n_pts} points: kernel {ms:.3f} ms ({k1:.3f}, {k2:.3f}; "
              f"{tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms ({p1:.3f}, {p2:.3f})", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


def _flop_per_point(packed, full):
    """Multiply-adds x 2 of the field's products, counted from the pack."""
    macs = sum(t.numel() for k, t in packed.items() if k[0] == "w" and k[1:2].isdigit())
    macs += packed["w_sigma"].numel()
    if full:
        macs += packed["w_comb"].numel() + packed["w_dir"].numel() + packed["w_rgb"].numel()
    return 2 * macs


def profile_frame(render, rays):
    """Device time per kernel over one frame, the device's idle share of the
    frame's host wall time, and the peak device memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(rays)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device kernel")
    per_name = {}
    for e in kernels:
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms, end = 0.0, -math.inf   # union of the kernels' intervals
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        end = max(end, e.time_range.end)
        busy_ms += max(0.0, e.time_range.end - start) / 1e3
    total = sum(ms for ms, _ in per_name.values())
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile] {ms:10.3f} ms {100 * ms / total:5.1f}% x{n:<4d} {name[:90]}",
              flush=True)
    print(f"[profile] device kernels {total:.3f} ms (busy {busy_ms:.3f} ms) in a "
          f"{wall_ms:.3f} ms frame: idle {100 * (1 - busy_ms / wall_ms):.2f}%; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one more frame after the main path")
    args = parser.parse_args()

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port on the card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"[1/4] device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import make_renderer
    from nerf_siren_tpu_torch.ops.kernels import _build
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("fused_mlp")
    print(f"[2/4] built csrc/fused_mlp.cu in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernels vs plain -----------------------------------------------
    models = make_models(device)
    packed = fm.pack_model_params(models)
    results = check_kernels(packed["fine"], device)
    torch.cuda.empty_cache()

    # ---- 4. main path: 3 frames through the eval renderer -------------------
    cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
                       noise_std=0.0, white_back=True, test_time=True, chunk=CHUNK)
    render = make_renderer(models, cfg, renderer="fused")
    frames_rays = [lego_rays(k, device) for k in range(N_FRAMES)]
    torch.cuda.synchronize()
    fm.LAUNCHES.update(sigma=0, full=0)
    outs, lat = [], []
    with torch.no_grad():
        for rays in frames_rays:
            t0 = time.perf_counter()
            outs.append(render(rays))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    launches = dict(fm.LAUNCHES)
    n_chunks = -(-H * W // CHUNK)
    print(f"[4/4] rendered {N_FRAMES} frames of {H}x{W} at {N_SAMPLES}+{N_IMPORTANCE} "
          f"samples: latency s {[round(t, 4) for t in lat]}, "
          f"{H * W / np.median(lat):.0f} rays/s at the median frame ({kind}, {smi}); "
          f"launches {launches}", flush=True)
    for name, (key, _) in KERNELS.items():
        if launches[key] < n_chunks * N_FRAMES:
            fail(f"{name} launched {launches[key]} times, expected >= {n_chunks * N_FRAMES}")
    for out in outs:
        for k, v in out.items():
            if v.shape[0] != H * W or not torch.isfinite(v).all():
                fail(f"{k}: shape {tuple(v.shape)} or non-finite values")
        rgb = out["rgb_fine"]
        if rgb.min() < 0 or rgb.max() > 1 + 1e-3:
            fail(f"rgb_fine outside [0, 1+1e-3]: {float(rgb.min())}..{float(rgb.max())}")
    print(f"[4/4] outputs finite; opacity_fine mean per frame "
          f"{[round(float(o['opacity_fine'].mean()), 4) for o in outs]}", flush=True)

    # the same rays re-rendered on the CPU, where the wrappers run the plain field
    cpu_packed = fm.pack_model_params({k: m.cpu() for k, m in models.items()}, "cpu")
    with torch.no_grad():
        ref = render_rays_fused(cpu_packed, frames_rays[0][CHECK_RAYS].cpu(), cfg)
    worst = {k: float((outs[0][k][CHECK_RAYS].cpu() - v).abs().max()) for k, v in ref.items()}
    print(f"[4/4] {CHECK_RAYS.stop - CHECK_RAYS.start} rays vs plain-field CPU render: "
          f"max|d| {worst} (atol {RENDER_ATOL})", flush=True)
    if max(worst.values()) > RENDER_ATOL:
        fail("main-path render disagrees with the plain-field render")
    if args.profile:
        profile_frame(render, frames_rays[1])

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "nerf_siren_tpu_torch/csrc/fused_mlp.cu",
         "replaces": replaces, "launches": launches[key], **results[name]}
        for name, (key, replaces) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
