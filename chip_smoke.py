#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: `python3 chip_smoke.py`.

Run from the repository root. Phases, each printing a line:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off.
  2. build: compiles the hand-written kernels from csrc/, one nvcc process
     per source, all started together (seconds printed).
  3. eval kernels (K1) vs plain: full-width 8x256 NeRF weights from a numpy seed,
     through convert.py and the kernel pack; each kernel against its plain
     PyTorch version at N = 1,000,003 points in the Blender box (|x| <= 4),
     max |delta| <= 2e-3 + 1e-2 |ref| (bf16 operands and float32
     accumulation on both sides, only the summation order differs); then
     the same check and each kernel's time beside the plain version's at the
     eval path's shapes (32768 rays x 64 sigma points; 32768 x 192 full
     points, one direction per ray).
  4. eval path: 3 Blender-lego 800x800 frames (64 + 128 samples, chunk
     32768, white background) through the port eval's `make_renderer` with
     the fused renderer; checks finite outputs, rgb in [0, 1 + 1e-3], each
     K1 kernel launched at least chunks x frames times, and 2048 rays of the
     first frame against a CPU re-render on the plain field (atol 5e-3).
  5. training kernels (K2) vs plain, at the training step's shapes (1024
     random rays of a lego frame x 64 coarse points, and x 192 fine points,
     one direction per ray): the forward within the K1 tolerance; every
     gradient tensor of the backward within relative L2 1e-2 and every
     element within 5e-2 of the tensor's largest magnitude (bf16 operands
     and cotangents on both sides; a ReLU mask that flips with a
     neighbouring bf16 value moves single elements). Each kernel timed
     beside its plain version, coarse + fine shapes (one step's work).
  6. training path: (a) one `NeRFSystem.train_step` on each backend
     (`fused`, `jnp`) from the same numpy-seeded weights and batch at
     perturb 0, noise 0: losses within a relative 2e-2; (b) 60 steps of the
     `fused` backend at opt.py's defaults (1024 rays, 64 + 128 samples,
     perturb 1, noise_std 1, Adam 5e-4) from another seed, on rays of the
     lego cameras with phase 4's renders of the seed-0 field as targets:
     every loss finite, the mean of the last 10 below the mean of the first
     10, each K2 kernel launched at least twice per step; ms per step, and
     the `jnp` backend's ms per step on the same batches.
  With `--profile`, one more frame and one more training step under
  `torch.profiler`: device time per kernel, the device's idle share and the
  peak device memory.
Then one JSON line of kernels, the nvidia-smi line, and the JSON result as
the last line. Any failure exits non-zero before the result is printed.
Bounds: the larger of the operations over the bf16 dense tensor-core peak
and the bytes (inputs read once, outputs written once) over the memory
rate of an H100 SXM (989 TFLOP/s, 3.35 TB/s).
"""
import argparse
import concurrent.futures
import copy
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
TRAIN_RAYS, TRAIN_STEPS, TRAIN_WARMUP, JNP_STEPS, LR = 1024, 60, 10, 12, 5e-4
TRAIN_LOSS_RTOL = 2e-2
GRAD_REL_L2, GRAD_ELEM = 1e-2, 5e-2
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12   # H100 SXM: dense bf16, HBM3
SOURCES = ("fused_mlp", "fused_mlp_train")
KERNELS = {   # wrapper name -> (launch counter key, source, TPU kernel it replaces)
    "fused_nerf_sigma": ("sigma", "fused_mlp", "nerf_siren_tpu/ops/pallas/fused_mlp.py:262"),
    "fused_nerf_full": ("full", "fused_mlp", "nerf_siren_tpu/ops/pallas/fused_mlp.py:272"),
    "fused_train_fwd": ("fwd", "fused_mlp_train",
                        "nerf_siren_tpu/ops/pallas/fused_mlp_train.py:255"),
    "fused_train_bwd": ("bwd", "fused_mlp_train",
                        "nerf_siren_tpu/ops/pallas/fused_mlp_train.py:266"),
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


def compare(name, got, ref, where, phase="3/6"):
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
    print(f"[{phase}] {name} vs plain {where}: max|d| {err:.3e} "
          f"(per column {[f'{v:.2e}' for v in delta.amax(0).tolist()]}), "
          f"{bad} outside {atol} + {rtol}|ref|", flush=True)
    if bad:
        fail(f"{name} disagrees with its plain version {where}")
    return err


def bound(flops, n_bytes):
    """(bound_ms, bound_by): the least time the card could take for the work."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_pair(kern, plain, reps=5):
    """(kernel ms, plain ms, the four runs), in turns: plain, kernel, kernel,
    plain. `kern` and `plain` are lists of callables run back to back."""
    def run_all(fns):
        return lambda: [f() for f in fns]

    p1, k1, k2, p2 = (cuda_ms(run_all(plain), 3), cuda_ms(run_all(kern), reps),
                      cuda_ms(run_all(kern), reps), cuda_ms(run_all(plain), 3))
    return (k1 + k2) / 2, (p1 + p2) / 2, (p1, k1, k2, p2)


def check_kernels(packed, device):
    """Phase 3: each K1 kernel against its plain version at N_CHECK points
    and at the eval path's shapes, then both timed at the latter."""
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
    for name, kern, plain, n_pts, n_bytes, where in (
            ("fused_nerf_sigma", lambda: fm.fused_nerf_sigma(packed, pts_c),
             lambda: fm.fused_sigma_ref(packed, pts_c), pts_c.shape[0],
             pts_c.shape[0] * (12 + 4), f"at {CHUNK} rays x {N_SAMPLES}"),
            ("fused_nerf_full", lambda: fm.fused_nerf_full(packed, pts_f, dirs, s_all),
             lambda: fm.fused_full_ref(packed, pts_f, dirs, s_all), pts_f.shape[0],
             pts_f.shape[0] * (12 + 16) + dirs.numel() * 4,
             f"at {CHUNK} rays x {s_all}, samples_per_dir {s_all}")):
        err = max(errs[name], compare(name, kern(), plain(), where))
        ms, plain_ms, (p1, k1, k2, p2) = timed_pair([kern], [plain])
        flops = n_pts * _flop_per_point(packed, name == "fused_nerf_full")
        n_bytes += sum(t.numel() * t.element_size() for t in packed.values())
        bound_ms, bound_by = bound(flops, n_bytes)
        print(f"[3/6] {name} at {n_pts} points: kernel {ms:.3f} ms ({k1:.3f}, {k2:.3f}; "
              f"{flops * 1e-12 / (ms * 1e-3):.1f} TFLOP/s), plain {plain_ms:.3f} ms "
              f"({p1:.3f}, {p2:.3f}); bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return results


def _flop_per_point(packed, full):
    """Multiply-adds x 2 of the field's products, counted from the pack."""
    macs = sum(t.numel() for k, t in packed.items() if k[0] == "w" and k[1:2].isdigit())
    macs += packed["w_sigma"].numel()
    if full:
        macs += packed["w_comb"].numel() + packed["w_dir"].numel() + packed["w_rgb"].numel()
    return 2 * macs


def train_macs_per_point(model):
    """Multiply-adds per point of K2's forward and backward, from the field's
    own weight shapes (no padding). The forward is one product per weight;
    the backward recomputes it, then takes every weight gradient (one
    product per weight) and every cotangent of a hidden input (the
    embedding columns need none)."""
    cfg = model.cfg
    fwd = sum(p.numel() for n, p in model.named_parameters() if n.endswith("weight"))
    emb_cols = cfg.width * cfg.in_channels_xyz * 2 + (cfg.width // 2) * cfg.in_channels_dir
    dgrad = fwd - emb_cols
    return fwd, fwd + fwd + dgrad


def grad_errors(got, ref):
    """(worst relative L2, max |delta|, worst |delta| over its tensor's
    largest magnitude, name of the worst L2) over gradient tensors; fails a
    tensor past GRAD_REL_L2 or an element past GRAD_ELEM of that scale."""
    import torch

    worst, max_abs, max_elem, worst_key = 0.0, 0.0, 0.0, ""
    for k, b in ref.items():
        a = got[k]
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"gradient {k}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        delta = (a - b).abs()
        rel = float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))
        elem = float(delta.max()) / max(float(b.abs().max()), 1e-30)
        if rel >= GRAD_REL_L2 or elem > GRAD_ELEM:
            fail(f"gradient {k}: relative L2 {rel:.3e}, max element {elem:.3e} of its scale")
        if rel >= worst:
            worst, worst_key = rel, k
        max_abs, max_elem = max(max_abs, float(delta.max())), max(max_elem, elem)
    return worst, max_abs, max_elem, worst_key


def check_train_kernels(model, frame_rays, device):
    """Phase 5: K2's forward and backward against their plain versions at
    the training step's shapes, then each timed (coarse + fine shapes)."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    rng = np.random.default_rng(SEED + 2)
    packed = k2.pack_train_params(model.state_dict())
    pick = torch.as_tensor(rng.permutation(frame_rays.shape[0])[:TRAIN_RAYS], device=device)
    rays = frame_rays[pick]
    dirs = rays[:, 3:6].contiguous()
    shapes = []
    for s in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        z = torch.linspace(NEAR, FAR, s, device=device)
        pts = (rays[:, None, :3] + rays[:, None, 3:6] * z[:, None]).reshape(-1, 3).contiguous()
        # cotangents of mixed sign around a positive mean, as a loss gives
        # them (a zero-mean dy makes every bias gradient a cancelling sum)
        dy = torch.tensor(rng.uniform(-0.5, 1.5, (pts.shape[0], 4)), dtype=torch.float32,
                          device=device)
        shapes.append((s, pts, dy))

    fwd_err = bwd_err = worst_rel = 0.0
    for s, pts, dy in shapes:
        where = f"at {TRAIN_RAYS} rays x {s}, samples_per_dir {s}"
        fwd_err = max(fwd_err, compare("fused_train_fwd", k2.fused_train_fwd(packed, pts, dirs, s),
                                       k2.fused_train_fwd_ref(packed, pts, dirs, s), where,
                                       "5/6"))
        got = k2.fused_train_bwd(packed, pts, dirs, dy, s)
        torch.cuda.synchronize()
        rel, max_abs, elem, key = grad_errors(got,
                                              k2.fused_train_bwd_ref(packed, pts, dirs, dy, s))
        print(f"[5/6] fused_train_bwd vs plain {where}: worst relative L2 {rel:.3e} ({key}), "
              f"max|d| {max_abs:.3e}, worst element {elem:.3e} of its tensor's scale, over "
              f"{len(got)} gradient tensors", flush=True)
        bwd_err, worst_rel = max(bwd_err, max_abs), max(worst_rel, rel)

    n_pts = sum(pts.shape[0] for _, pts, _ in shapes)
    fwd_macs, bwd_macs = train_macs_per_point(model)
    w_bytes = sum(t.numel() * t.element_size() for t in packed.values())
    g_bytes = sum(p.numel() * 4 for p in model.parameters())
    in_bytes = n_pts * 12 + len(shapes) * dirs.numel() * 4 + w_bytes
    results = {}
    for name, kern, plain, flops, n_bytes in (
            ("fused_train_fwd",
             [lambda s=s, p=p: k2.fused_train_fwd(packed, p, dirs, s) for s, p, _ in shapes],
             [lambda s=s, p=p: k2.fused_train_fwd_ref(packed, p, dirs, s) for s, p, _ in shapes],
             2 * fwd_macs * n_pts, in_bytes + n_pts * 16),
            ("fused_train_bwd",
             [lambda s=s, p=p, d=d: k2.fused_train_bwd(packed, p, dirs, d, s)
              for s, p, d in shapes],
             [lambda s=s, p=p, d=d: k2.fused_train_bwd_ref(packed, p, dirs, d, s)
              for s, p, d in shapes],
             2 * bwd_macs * n_pts, in_bytes + n_pts * 16 + len(shapes) * g_bytes)):
        ms, plain_ms, (p1, k1, k2_, p2) = timed_pair(kern, plain)
        bound_ms, bound_by = bound(flops, n_bytes)
        print(f"[5/6] {name}, one step's shapes ({n_pts} points): kernel {ms:.3f} ms "
              f"({k1:.3f}, {k2_:.3f}; {flops * 1e-12 / (ms * 1e-3):.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms ({p1:.3f}, {p2:.3f}); bound {bound_ms:.3f} ms ({bound_by}, "
              f"{flops * 1e-12:.3f} TFLOP)", flush=True)
        results[name] = {"max_abs_err": fwd_err if name == "fused_train_fwd" else bwd_err,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
    return results


def numpy_models(seed, device):
    """Coarse and fine full-width `NeRF`s with weights from a numpy seed."""
    from nerf_siren_tpu_torch.config import NeRFConfig
    from nerf_siren_tpu_torch.convert import nerf_from_jax
    from nerf_siren_tpu_torch.models.nerf import NeRF

    rng = np.random.default_rng(seed)
    models = {}
    for name in ("coarse", "fine"):
        model = NeRF(NeRFConfig())
        model.load_state_dict(nerf_from_jax(numpy_nerf_params(rng, model.cfg)))
        models[name] = model.to(device)
    return models


def train_system(backend, perturb, noise_std, steps_per_epoch, device):
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.training.system import NeRFSystem

    render_cfg = RenderConfig(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=perturb,
                              noise_std=noise_std, white_back=True)
    # opt.py's defaults: Adam, lr 5e-4, steplr at epoch 20 by 0.1
    train_cfg = TrainConfig(lr=LR, decay_step=(20,), decay_gamma=0.1, batch_size=TRAIN_RAYS)
    return NeRFSystem(render_cfg, train_cfg, NeRFConfig(), steps_per_epoch,
                      train_backend=backend, device=device)


def train_phase(pool_rays, pool_rgbs, device, card):
    """Phase 6: one step on each backend, then TRAIN_STEPS fused steps.
    Returns (K2 launches of the fused run, ms per step)."""
    import torch
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    steps_per_epoch = pool_rays.shape[0] // TRAIN_RAYS

    def batch():
        idx = torch.randint(0, pool_rays.shape[0], (TRAIN_RAYS,), generator=gen, device=device)
        return {"rays": pool_rays[idx], "rgbs": pool_rgbs[idx]}

    # (a) the two backends from the same weights and batch, deterministic
    student = numpy_models(SEED + 10, device)
    first, losses = batch(), {}
    for backend in ("fused", "jnp"):
        system = train_system(backend, 0.0, 0.0, steps_per_epoch, device)
        state = system.state_for(copy.deepcopy(student))
        _, metrics = system.train_step(state, first, seed=SEED)
        losses[backend] = float(metrics["train/loss"])
    rel = abs(losses["fused"] - losses["jnp"]) / abs(losses["jnp"])
    print(f"[6/6] first step, same weights and batch: loss fused {losses['fused']:.6f}, "
          f"jnp {losses['jnp']:.6f}, relative {rel:.3e} (bar {TRAIN_LOSS_RTOL})", flush=True)
    if not rel < TRAIN_LOSS_RTOL:
        fail("the fused and jnp backends disagree on the first step's loss")

    # (b) the fused backend at opt.py's defaults
    system = train_system("fused", 1.0, 1.0, steps_per_epoch, device)
    state = system.state_for(student)
    batches = [batch() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    k2.LAUNCHES.update(fwd=0, bwd=0)
    loss_t, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = system.train_step(state, b, seed=SEED + 1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        loss_t.append(metrics["train/loss"])
    launches = dict(k2.LAUNCHES)
    loss = [float(v) for v in loss_t]
    ms = 1e3 * float(np.median(step_s[TRAIN_WARMUP:]))
    head, tail = float(np.mean(loss[:10])), float(np.mean(loss[-10:]))
    print(f"[6/6] fused training, {TRAIN_STEPS} steps of {TRAIN_RAYS} rays at "
          f"{N_SAMPLES}+{N_IMPORTANCE} samples: loss first 10 mean {head:.5f}, last 10 mean "
          f"{tail:.5f}; loss every 10th step {[round(v, 5) for v in loss[::10]]}; "
          f"{ms:.3f} ms per step (median after {TRAIN_WARMUP}); "
          f"{1e3 * TRAIN_RAYS / ms:.0f} rays/s ({card}); launches {launches}", flush=True)
    if not all(math.isfinite(v) for v in loss):
        fail("a training loss is not finite")
    if not tail < head:
        fail("the fused training loss did not fall")
    for key in ("fwd", "bwd"):
        if launches[key] < 2 * TRAIN_STEPS:
            fail(f"K2 {key} launched {launches[key]} times, expected >= {2 * TRAIN_STEPS}")

    # the plain backend's step on the same batches, for comparison
    plain = train_system("jnp", 1.0, 1.0, steps_per_epoch, device)
    plain_state, plain_s = plain.state_for(copy.deepcopy(state.models)), []
    for b in batches[:JNP_STEPS]:
        t0 = time.perf_counter()
        plain_state, _ = plain.train_step(plain_state, b, seed=SEED + 1)
        torch.cuda.synchronize()
        plain_s.append(time.perf_counter() - t0)
    plain_ms = 1e3 * float(np.median(plain_s[2:]))
    print(f"[6/6] jnp backend on the same batches: {plain_ms:.3f} ms per step (median of "
          f"{JNP_STEPS - 2} after 2; {card}); fused / jnp step time {ms / plain_ms:.3f}",
          flush=True)
    return launches, ms, (system, state, batches[-1])


def profile(label, fn):
    """Device time per kernel over one call of `fn`, the device's idle
    share of its host wall time, and the peak device memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    for name, (ms, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"[profile {label}] {ms:10.3f} ms {100 * ms / total:5.1f}% x{n:<4d} {name[:90]}",
              flush=True)
    print(f"[profile {label}] device kernels {total:.3f} ms (busy {busy_ms:.3f} ms) in "
          f"{wall_ms:.3f} ms of host time: idle {100 * (1 - busy_ms / wall_ms):.2f}%; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one more frame and one more training step")
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
    print(f"[1/6] device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from nerf_siren_tpu_torch.config import RenderConfig
    from nerf_siren_tpu_torch.eval import make_renderer
    from nerf_siren_tpu_torch.ops.kernels import _build
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_siren_tpu_torch.render.fused import render_rays_fused

    # ---- 2. build: one nvcc per source, all at once --------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    print(f"[2/6] built {', '.join(f'csrc/{n}.cu' for n in SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. K1 vs plain ------------------------------------------------------
    models = numpy_models(SEED, device)
    packed = fm.pack_model_params(models)
    results = check_kernels(packed["fine"], device)
    torch.cuda.empty_cache()

    # ---- 4. eval path: 3 frames through the eval renderer --------------------
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
    print(f"[4/6] rendered {N_FRAMES} frames of {H}x{W} at {N_SAMPLES}+{N_IMPORTANCE} "
          f"samples: latency s {[round(t, 4) for t in lat]}, "
          f"{H * W / np.median(lat):.0f} rays/s at the median frame ({kind}, {smi}); "
          f"launches {launches}", flush=True)
    for key in ("sigma", "full"):
        if launches[key] < n_chunks * N_FRAMES:
            fail(f"K1 {key} launched {launches[key]} times, expected >= {n_chunks * N_FRAMES}")
    for out in outs:
        for k, v in out.items():
            if v.shape[0] != H * W or not torch.isfinite(v).all():
                fail(f"{k}: shape {tuple(v.shape)} or non-finite values")
        rgb = out["rgb_fine"]
        if rgb.min() < 0 or rgb.max() > 1 + 1e-3:
            fail(f"rgb_fine outside [0, 1+1e-3]: {float(rgb.min())}..{float(rgb.max())}")
    print(f"[4/6] outputs finite; opacity_fine mean per frame "
          f"{[round(float(o['opacity_fine'].mean()), 4) for o in outs]}", flush=True)

    # the same rays re-rendered on the CPU, where the wrappers run the plain field
    cpu_packed = fm.pack_model_params({k: copy.deepcopy(m).cpu() for k, m in models.items()},
                                      "cpu")
    with torch.no_grad():
        ref = render_rays_fused(cpu_packed, frames_rays[0][CHECK_RAYS].cpu(), cfg)
    worst = {k: float((outs[0][k][CHECK_RAYS].cpu() - v).abs().max()) for k, v in ref.items()}
    print(f"[4/6] {CHECK_RAYS.stop - CHECK_RAYS.start} rays vs plain-field CPU render: "
          f"max|d| {worst} (atol {RENDER_ATOL})", flush=True)
    if max(worst.values()) > RENDER_ATOL:
        fail("main-path render disagrees with the plain-field render")
    if args.profile:
        with torch.no_grad():
            profile("eval frame", lambda: render(frames_rays[1]))

    # ---- 5. K2 vs plain at the training shapes -------------------------------
    results.update(check_train_kernels(models["fine"], frames_rays[0], device))
    torch.cuda.empty_cache()

    # ---- 6. training path: the teacher's frames are the targets ---------------
    pool_rays = torch.cat(frames_rays)
    pool_rgbs = torch.cat([o["rgb_fine"] for o in outs])
    del outs
    train_launches, step_ms, (system, state, last) = train_phase(pool_rays, pool_rgbs, device, smi)
    launches.update(train_launches)
    if args.profile:
        profile("train step", lambda: system.train_step(state, last, seed=SEED + 1))

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"nerf_siren_tpu_torch/csrc/{src}.cu",
         "replaces": replaces, "launches": launches[key], **results[name]}
        for name, (key, src, replaces) in KERNELS.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
