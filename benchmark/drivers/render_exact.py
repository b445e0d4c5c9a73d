"""Frame traffic: 800x800 frames through the eval CLI's renderer, timed.

Set-up makes the fields' weights on the device from the seed (the
traffic's `weights`: 'ball', a ball of density with empty space around
it), the rays of the traffic's cameras on the device, and the renderer as
`eval.py` builds it (`make_renderer`, `renderer` 'fused': the exact
coarse + fine math with both field passes on K1, tiled by `chunk`). It
renders `warmup_frames` frames.

The window is a closed loop with one client: frame after frame, poses
cycling over the cameras, each frame a host clock around the render call
and a synchronise. The cell's `e2e_names` name its end-to-end metrics:
the rate, all the pixels of all the window's frames over the window, and,
where the cell has one, the tail, the 95th percentile of all its frames'
latencies. A traced run
profiles `traced_frames` frames before the window.

Each frame keeps its outputs at `check_rays` rays a camera drawn from the
seed. Once the window has closed and the peak memory is read, the
program's state is freed and the reference renders those rays for
`check_frames` frames drawn from the seed (the exact render, whichever
renderer the cell drives). Ray by ray, the gaps of rgb (the worst
channel), depth (over far - near) and opacity are read at their widest
(`<output>_gap`) and at their 99th percentile over the rays (`.p99`); the
cell's `limits` name those compared.
"""
from __future__ import annotations

import gc
import importlib
import statistics
import time

import torch

from benchmark import scenes
from benchmark.harness import tf32, traced_slice

OUTPUTS = ("rgb_fine", "depth_fine", "opacity_fine", "opacity_coarse")   # those a renderer gives


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_of(cfg: dict):
    return importlib.import_module(f"benchmark.models.{cfg['model']}")


def frame(run, render, rays):
    """One frame: the render call, then a synchronise; (outputs, host ms)."""
    t = time.perf_counter()
    with run.spans.span("frame_call"):
        out = render(rays)
    with run.spans.span("frame_sync"):
        sync(run.device)
    return out, 1e3 * (time.perf_counter() - t)


def frame_latencies_ms(run, render, frames, check_idx, seconds: float, kept: list):
    """Frames in a closed loop for `seconds`: each frame's host ms, with the
    outputs of its checked rays appended to `kept` as (camera, outputs)."""
    lat = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        cam = k % frames.shape[0]
        out, ms = frame(run, render, frames[cam])
        lat.append(ms)
        kept.append((cam, {key: out[key][check_idx[cam]] for key in OUTPUTS if key in out}))
        k += 1
    return lat, time.perf_counter() - t0


def setup(run):
    cfg, tr, dev = run.config, run.traffic, run.device
    model = model_of(cfg)
    with run.spans.span("setup.weights"):
        weights = model.make_weights(cfg, scenes.torch_generator(run.seed, dev, 0),
                                     tr["weights"])
    with run.spans.span("setup.rays"):
        frames = scenes.frame_rays(tr["cameras"], run.seed, dev)
        g = scenes.torch_generator(run.seed, dev, 3)
        check_idx = torch.randint(0, frames.shape[1], (frames.shape[0], tr["check_rays"]),
                                  generator=g, device=dev)
    with run.spans.span("setup.renderer"):
        render = model.render_setup(run, cfg, tr, weights, dev)
    return model, weights, frames, check_idx, render


def reference_gaps(run, model, weights, frames, check_idx, kept, precision: str) -> dict:
    """The reference's render of the kept rays of `check_frames` frames drawn
    from the seed, and the gaps of the program's outputs to it, ray by ray:
    rgb (the worst channel), depth over far - near, opacity (each opacity
    the renderer gives), at their widest and at the 99th percentile over the
    rays."""
    cfg = run.config
    pick = scenes.rng(run.seed, 4).choice(len(kept), min(len(kept), run.traffic["check_frames"]),
                                          replace=False)
    op = model.REFERENCE.operand_round(precision)
    span = cfg["far"] - cfg["near"]
    per_ray = {"rgb": [], "depth": [], "opacity": []}
    for i in sorted(pick):
        cam, got = kept[int(i)]
        rays = frames[cam][check_idx[cam]]
        with torch.no_grad(), tf32(False):
            want = model.reference_render(weights, cfg, rays, op)
        per_ray["rgb"].append(_gap(got["rgb_fine"], want["rgb_fine"]).amax(-1))
        per_ray["depth"].append(_gap(got["depth_fine"], want["depth_fine"]) / span)
        per_ray["opacity"].append(torch.stack([_gap(got[k], want[k]) for k in
                                               ("opacity_fine", "opacity_coarse") if k in got])
                                  .amax(0))
    out = {}
    for name, gaps in per_ray.items():
        g = torch.cat(gaps)
        g = torch.where(torch.isnan(g), torch.full_like(g, float("inf")), g)
        out[f"{name}_gap"] = float(g.max())
        out[f"{name}_gap.p99"] = float(torch.quantile(g, 0.99))
    return out


def control(run) -> dict:
    """The control's readings: the reference computed at the configuration's
    `control_precision`, put in the program's place, on the rays a run
    checks, against the reference."""
    model, weights, frames, check_idx, render = setup(run)
    del render
    op = model.REFERENCE.operand_round(run.config["control_precision"])
    n = frames.shape[0]
    with torch.no_grad(), tf32(False):
        kept = [(cam, model.reference_render(weights, run.config, frames[cam][check_idx[cam]],
                                             op))
                for cam in range(min(n, run.traffic["check_frames"]))]
    return reference_gaps(run, model, weights, frames, check_idx, kept,
                          run.config["precision"])


def _gap(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| of each element, in float64."""
    return (got.double() - want.double()).abs()


def run(run) -> None:
    tr, dev = run.traffic, run.device
    model, weights, frames, check_idx, render = setup(run)
    with torch.no_grad():
        with run.spans.span("setup.warmup"):
            for k in range(tr["warmup_frames"]):
                render(frames[k % frames.shape[0]])
            sync(dev)
        if run.trace:
            with traced_slice(run):
                for k in range(tr["traced_frames"]):
                    frame(run, render, frames[k % frames.shape[0]])
            run.readings["traced_frames"] = tr["traced_frames"]
        run.setup_done()
        run.readings["t_window"] = time.perf_counter()
        kept: list = []
        lat, window = frame_latencies_ms(run, render, frames, check_idx, run.seconds, kept)
    n_pix = frames.shape[1]
    run.attempted = len(lat)
    run.failed = sum(1 for _, out in kept
                     if not all(bool(torch.isfinite(v).all()) for v in out.values()))
    names = run.workload["e2e_names"]
    run.e2e[names["rays_per_s"]] = len(lat) * n_pix / window
    if "frame_p95_ms" in names:
        run.e2e[names["frame_p95_ms"]] = (statistics.quantiles(lat, n=20)[18] if len(lat) > 1
                                          else lat[0])
    run.readings.update(window_s=window, frames=len(lat), rays_per_frame=n_pix,
                        **model.frame_work(run.config, tr, n_pix, run.readings))
    if dev.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del render
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.record_checks(reference_gaps(run, model, weights, frames, check_idx, kept,
                                     run.config["precision"]))
