"""One run of one benchmark cell: the part every cell shares.

`run.py` calls `main`. The harness reads `BENCHMARK.json` and finds the
cell's files by name: `workloads/<cell>.json` (its configuration, its
driver and its traffic), `configs/<config>.json` (the sizes),
`drivers/<driver>.py` (the loop that drives the program) and, with
`--trace 1`, `metrics/<metric>.py` (a per-layer metric's reader; see
`metric_file` for readers that metrics share). It
points every cache at a fixed directory under `benchmark/.cache/`,
refuses a run without the cards the cell asks for, hands the driver a
`Run`, and prints the result line.

A driver fills the `Run`: `e2e` (the end-to-end metrics by name),
`readings` (named numbers the per-layer readers take), `checks` (each
number the correctness comparison compared, with its limit), the spans
(`run.spans`) and, in a traced run, the profile of a steady slice
(`run.profile`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
# top-level module names that may not be loaded in the process that prints the result
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nerf_siren_tpu")
SLICE = "traced_slice"   # the span around a traced slice: gaps in no other span take its name


def process_start_time() -> float:
    """The process's start on the `time.time()` clock (Linux: /proc), or
    now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout. The
    port's own kernel libraries already build into
    `nerf_siren_tpu_torch/_build/`. No library the program uses loads JAX
    by itself; `USE_FLAX=0` keeps `transformers`-style loaders off it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Tuple[dict, dict]:
    """(workload, config) of a cell, each read from its own file by name."""
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    workload["name"] = name
    config = load_json(bench_dir / "configs" / f"{workload['config']}.json")
    return workload, config


def load_module(path: Path, name: str):
    """A benchmark file loaded by its path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """The reader of a per-layer metric: `metrics/<name>.py`, or, where the
    metric has none of its own, the reader of the name without its last
    dotted part (`enqueue_ms.fast` is read by `metrics/enqueue_ms.py`)."""
    own = bench_dir / "metrics" / f"{name}.py"
    if own.is_file() or "." not in name:
        return own
    return metric_file(name.rsplit(".", 1)[0], bench_dir)


def metrics_of(man: dict, cell: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ('end_to_end' or 'per_layer'): those
    that list it, or list no cells."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


# -- spans and the traced slice ----------------------------------------------------

class Spans:
    """Host spans (name, start, end) on `time.perf_counter`, kept in memory.
    While a profile records, each span is also a profiler annotation, so the
    idle gaps of the device trace can be named by the span that was open."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str, since: float = -math.inf) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.records if n == name and t0 >= since]


@dataclasses.dataclass
class Profile:
    """What a traced slice holds: device operations (name, start us, end
    us), the harness's annotations (name, start us, end us) and the host
    seconds of the slice."""
    ops: List[Tuple[str, float, float]]
    notes: List[Tuple[str, float, float]]
    window_s: float
    bounds: Tuple[float, float] = (-math.inf, math.inf)   # the slice, us on the trace's clock

    def busy_s(self) -> float:
        """Seconds of the slice in which some operation ran on the device
        (the union of their intervals)."""
        lo, hi = self.bounds
        busy, end = 0.0, lo
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, lo), min(e, hi)
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def op_seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the operations whose name `match`es."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        per: Dict[str, float] = {}
        for n, s, e in self.ops:
            per[n] = per.get(n, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Device idle seconds of the slice (between operations, and before
        the first and after the last), summed by the innermost harness span
        open on the host when each gap began."""
        lo, hi = self.bounds
        per: Dict[str, float] = {}
        end = lo
        for _, s, e in sorted(self.ops, key=lambda o: o[1]) + [("", hi, hi)]:
            if s > end:
                per[self._open_at(end)] = per.get(self._open_at(end), 0.0) + (s - end) / 1e6
            end = max(end, e)
        return [[n, v] for n, v in sorted(per.items(), key=lambda kv: -kv[1])[:k]]

    def _open_at(self, t: float) -> str:
        inside = [(e - s, n) for n, s, e in self.notes if s <= t <= e]
        return min(inside)[1] if inside else SLICE


@contextlib.contextmanager
def traced_slice(run: "Run"):
    """Profile what runs inside (CPU and CUDA activity), synchronised at both
    ends, into `run.profile`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = run.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize(run.device)
    run.spans.annotate = True
    with profile(activities=activities) as prof:
        with run.spans.span(SLICE):
            yield
            if card:
                torch.cuda.synchronize(run.device)
    run.spans.annotate = False
    names = {n for n, _, _ in run.spans.records}
    ops, notes = [], []
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.name in names:   # the harness's spans (the trace shows them on both timelines)
            if ev.device_type != DeviceType.CUDA:
                notes.append((ev.name, *rng))
        elif ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, *rng))
    # the slice on the trace's own clock: device time and host spans alike
    lo, hi = next((s, e) for n, s, e in notes if n == SLICE)
    run.profile = Profile([o for o in ops if o[2] > lo and o[1] < hi], notes, (hi - lo) / 1e6,
                          (lo, hi))


# -- the run ------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any                      # torch.device
    t_start: float                   # process start, time.time() clock
    spans: Spans = dataclasses.field(default_factory=Spans)
    profile: Optional[Profile] = None
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]

    def setup_done(self) -> None:
        """The first timed operation starts now: record `setup_s`."""
        self.e2e["setup_s"] = time.time() - self.t_start

    def check(self, name: str, value: float, limit: float) -> None:
        """A compared number and its limit: correct while value <= limit (a
        number that is not finite fails)."""
        self.checks.append((name, float(value), float(limit)))

    def record_checks(self, readings: Dict[str, float]) -> None:
        """The readings the cell's `limits` name are checks; the others are
        printed beside them (`readings`)."""
        limits = self.workload["limits"]
        for name, value in readings.items():
            if name in limits:
                self.check(name, value, limits[name])
            else:
                self.readings["check." + name] = float(value)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim
                                         for _, v, lim in self.checks)


@contextlib.contextmanager
def tf32(enabled: bool):
    """PyTorch's float32 matmuls and cuDNN convolutions in TF32, or not,
    while the block runs. The program runs under PyTorch's defaults, as its
    CLIs do; the reference runs without TF32 (on a card cuDNN would
    otherwise take its convolutions in TF32) and rounds its operands
    itself."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def driver_module(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "drivers" / f"{name}.py", f"bench_driver_{name}")


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[dict] = None, bench_dir: Path = BENCH_DIR,
             t_start: Optional[float] = None) -> Run:
    """Drive one cell on `device` and return its filled `Run`. `overrides`
    ({'traffic': {...}, 'config': {...}}) replace keys of the cell's files:
    the CPU tests shrink a cell with them."""
    workload, config = load_cell(cell, bench_dir)
    overrides = overrides or {}
    config = dict(config, **overrides.get("config", {}))
    workload["traffic"] = dict(workload["traffic"], **overrides.get("traffic", {}))
    run = Run(workload, config, seed, seconds, trace, device,
              t_start if t_start is not None else time.time())
    run.spans.records.append(("setup.process", run.t_start - time.time() + time.perf_counter(),
                              time.perf_counter()))
    driver_module(workload["driver"], bench_dir).run(run)
    return run


def result_line(run: Run, man: dict, cell: str, device_info: dict,
                bench_dir: Path = BENCH_DIR) -> dict:
    """The result object: the cell's end-to-end metrics (untraced) or the
    per-layer metrics its readers find (traced), then the checks, last."""
    metrics: Dict[str, dict] = {}
    if run.trace:
        for m in metrics_of(man, cell, "per_layer"):
            reader = load_module(metric_file(m["name"], bench_dir),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(man, cell, "end_to_end"):
            metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=run.memory_peak_bytes)
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s()
        device["window_s"] = run.profile.window_s
        out["breakdown"] = {"device_ops": run.profile.top_ops(),
                            "idle_gaps": run.profile.idle_gaps()}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return out


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell of the PyTorch port.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start_time()
    args = parse_args(argv)
    set_cache_dirs()
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}: one of {sorted(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}. No result.", file=sys.stderr)
        return 3
    run = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start=t_start)
    found = forbidden_loaded()
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port only. "
              f"No result.", file=sys.stderr)
        return 4
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    out = result_line(run, man, args.workload, info)
    setup = [(n, t1 - t0) for n, t0, t1 in run.spans.records if n.startswith("setup.")]
    print("set-up: " + ", ".join(f"{n[6:]} {d:.3f} s" for n, d in setup), file=sys.stderr)
    for name, value in run.readings.items():
        if name.startswith("check."):
            print(f"reading {name[6:]}: {value!r} (not compared)", file=sys.stderr)
    for name, value, limit in run.checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
