"""Timing on one card, and variants of a kernel's source built for it.

Shared by `chip_smoke.py` (`device_ms`) and the ablation tools
(`k1_ablation`, `k5_ablation`), which time a kernel's source with one part
of its design taken out:
- `device_ms`: ms per call of a function over repeated calls, CUDA events;
  optionally queued behind a device-side sleep;
- `kernel_ms`: device ms per call of each kernel a function launches,
  `torch.profiler`;
- `edit`: one text edit of a source, failing when its place is gone;
- `build_variants`: each {label: source text} compiled like the kernel
  (`ops/kernels/_build.py`'s flags) into a temporary directory, one nvcc
  each, all at once, and its C entry point loaded with ctypes
  (`build_variant_libs`: the libraries, for more than one entry point);
- `ptxas_props`: registers, spills and stack of each kernel in a build's
  `-Xptxas -v` report;
- `card`: the card's name and power limit as nvidia-smi prints them.
Needs nvcc and a card for all but `edit`.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

import torch

from nerf_siren_tpu_torch.ops.kernels import _build

QUEUE_CYCLES = 20_000_000   # ~11 ms of device sleep at 1.755 GHz


def device_ms(fn: Callable[[], object], reps: int, queued: bool = False) -> float:
    """ms per call of fn over reps calls, after one call to warm up.
    `queued` puts the calls behind QUEUE_CYCLES of device-side sleep, so
    that the host time of launching them is not counted: for kernels that
    take less time on the card than their launch takes on the host. Only
    for fn that never waits for the card (a wait would count the sleep)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn: Callable[[], object], reps: int) -> Dict[str, float]:
    """{kernel name: device ms per call of fn}, over reps calls under
    `torch.profiler` after one call to warm up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    if not per:
        raise RuntimeError("the profiler recorded no device kernel")
    return per


def edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the kernel source no longer holds {old[:60]!r}")
    return src.replace(old, new)


class Variant(NamedTuple):
    label: str
    fn: Callable[..., int]  # the entry point, argtypes and restype set
    log: str                # nvcc's -Xptxas -v report


def build_variants(variants: Dict[str, str], entry: str, argtypes: list) -> List[Variant]:
    """Each source text compiled (its includes found in csrc/) and loaded;
    in the order of `variants`. The libraries stay loaded after their files
    are deleted."""
    out = []
    for label, lib, log in build_variant_libs(variants):
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        out.append(Variant(label, fn, log))
    return out


def build_variant_libs(variants: Dict[str, str]) -> List[tuple]:
    """(label, loaded library, nvcc's -Xptxas -v report) of each source
    text, compiled as `build_variants` does."""
    with tempfile.TemporaryDirectory() as tmp:
        def build(label: str, text: str) -> tuple:
            name = re.sub(r"\W", "_", label)
            src, lib = Path(tmp) / f"{name}.cu", Path(tmp) / f"lib{name}.so"
            src.write_text(text)
            proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                                   str(_build.CSRC_DIR), "-o", str(lib), str(src)],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on the {label!r} variant:\n{proc.stderr}")
            return label, ctypes.CDLL(str(lib)), proc.stdout + proc.stderr

        with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
            return list(pool.map(lambda kv: build(*kv), variants.items()))


def ptxas_props(log: str) -> Dict[str, tuple]:
    """{mangled kernel name: (registers, spill store + load bytes, stack
    frame bytes)} from an `nvcc -Xptxas -v` report."""
    report, kernel, props = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            props = (int(m.group(2)) + int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            report[kernel] = (int(m.group(1)), *props)
            props = (0, 0)
    return report


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
