"""Shared arithmetic of the per-layer readers: the table of peaks and the
roofline of counted work. A reader that finds nothing returns None."""
from __future__ import annotations

import re
from typing import Optional

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def roofline_pct(run, pattern: str, flops: float, n_bytes: float) -> Optional[float]:
    """100 x the least time the card could take for the counted work (the
    larger of its flops at the bf16 peak and its bytes at HBM's) over the
    device time of the kernels whose names match `pattern` in the traced
    slice."""
    if run.profile is None:
        return None
    rx = re.compile(pattern)
    seconds = run.profile.op_seconds(lambda name: bool(rx.search(name)))
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * max(flops / PEAK_BF16_FLOPS, n_bytes / PEAK_HBM_BYTES) / seconds


def idle_pct(run) -> Optional[float]:
    if run.profile is None or run.profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.window_s)


def mean_span_ms(run, name: str) -> Optional[float]:
    """Mean host milliseconds of the span `name` within the measured window."""
    d = run.spans.durations(name, since=run.readings.get("t_window", float("inf")))
    return 1e3 * sum(d) / len(d) if d else None


# kernel names as the device trace shows them (`csrc/`), by the kernel's tag
KERNEL_NAMES = {
    "k1": r"nerf_field_kernel|nerf_field_wide_kernel",
    "k4": r"nerf_field_int8_kernel|int8_constants_kernel",
    "k2": r"nerf_train_(fwd_tile|bwd_tile|wgrad|reduce)_kernel",
    "k3": r"proxy_march",
}


def frame_roofline_pct(run, kernel: str) -> Optional[float]:
    """A kernel's roofline share over the traced frames (`<kernel>_frame_flops`
    and `_bytes` a frame in the readings)."""
    r = run.readings
    frames = r.get("traced_frames")
    if not frames or not r.get(f"{kernel}_frame_flops"):
        return None
    return roofline_pct(run, KERNEL_NAMES[kernel], frames * r[f"{kernel}_frame_flops"],
                        frames * r[f"{kernel}_frame_bytes"])


def frame_mfu_pct(run) -> Optional[float]:
    """The model flops the window's frames need over its seconds and the peak."""
    r = run.readings
    if not r.get("frames") or not r.get("window_s") or not r.get("frame_flops"):
        return None
    return 100.0 * r["frame_flops"] * r["frames"] / r["window_s"] / PEAK_BF16_FLOPS


def renderer_other_ms(run) -> Optional[float]:
    """Device ms a traced frame of every operation but the field (K1, K4) and
    proxy (K3) kernels."""
    frames = run.readings.get("traced_frames")
    if run.profile is None or not frames:
        return None
    rx = re.compile("|".join(KERNEL_NAMES[k] for k in ("k1", "k4", "k3")))
    return 1e3 * run.profile.op_seconds(lambda n: not rx.search(n)) / frames
