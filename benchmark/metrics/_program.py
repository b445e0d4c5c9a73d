"""What the readers of the program's own spans and counters share
(`nerf_siren_tpu_torch/utils/tracing.py`, which records while a profiler
records, so over the traced slice): the program's spans of the traced
slice, lined up with the device trace's clock, their self times, and the
device's idle gaps put down to the innermost program span open when each
began. A program without that module, or a run without a profile, gives
nothing, and the readers return None.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

from benchmark.harness import SLICE


def tracing():
    """The program's tracing module, or None where the program has none."""
    try:
        from nerf_siren_tpu_torch.utils import tracing as module
    except ImportError:
        return None
    return module


def slice_bounds(run) -> Optional[Tuple[float, float]]:
    """The traced slice on `time.perf_counter` (the harness's span)."""
    return next(((t0, t1) for n, t0, t1 in run.spans.records if n == SLICE), None)


def slice_records(run) -> Optional[list]:
    """The program's spans that lie inside the traced slice, or None."""
    module, bounds = tracing(), slice_bounds(run)
    if module is None or bounds is None or run.profile is None:
        return None
    lo, hi = bounds
    return [r for r in module.records() if lo <= r.start and r.end <= hi]


def clock_offset(run) -> Optional[float]:
    """Seconds to add to a `perf_counter` time to put it on the device
    trace's clock: the median, over the harness spans found both in the
    run's spans and as annotations in the trace (`traced_slice`,
    `frame_call`, `dispatch`, ...), of the trace's start less the host
    clock's. A name whose counts differ between the two is left out."""
    bounds = slice_bounds(run)
    if bounds is None or run.profile is None:
        return None
    lo, hi = bounds
    offsets = []
    for name in {n for n, _, _ in run.profile.notes}:
        notes = sorted(s for n, s, _ in run.profile.notes if n == name)
        starts = sorted(t0 for n, t0, t1 in run.spans.records
                        if n == name and lo <= t0 and t1 <= hi)
        if len(notes) == len(starts):
            offsets += [s / 1e6 - t0 for s, t0 in zip(notes, starts)]
    return statistics.median(offsets) if offsets else None


def on_trace(run) -> Optional[List[Tuple[str, float, float]]]:
    """The program's spans of the traced slice as (name, start us, end us)
    on the trace's clock."""
    recs, offset = slice_records(run), clock_offset(run)
    if recs is None or offset is None:
        return None
    return [(r.name, (r.start + offset) * 1e6, (r.end + offset) * 1e6) for r in recs]


def idle_gaps(profile) -> List[Tuple[float, float]]:
    """The slice's intervals (us) in which no operation ran on the device,
    as the harness's `Profile.idle_gaps` finds them."""
    lo, hi = profile.bounds
    gaps, end = [], lo
    for _, s, e in sorted(profile.ops, key=lambda o: o[1]) + [("", hi, hi)]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    return gaps


def idle_by_span(run) -> Optional[Dict[Optional[str], float]]:
    """Device idle seconds of the slice by the innermost program span (the
    shortest) open on the host when each gap began; None: no program span
    was open."""
    spans = on_trace(run)
    if spans is None:
        return None
    spans.sort(key=lambda s: s[1])
    out: Dict[Optional[str], float] = {}
    open_, i = [], 0
    for g0, g1 in idle_gaps(run.profile):
        while i < len(spans) and spans[i][1] <= g0:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s[2] >= g0]
        name = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else None
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return out


def host_idle_pct(run) -> Optional[float]:
    """The share of the traced slice in which the device was idle in gaps
    that began while a program span was open on the host."""
    by_span = idle_by_span(run)
    if by_span is None or run.profile.window_s <= 0:
        return None
    return 100.0 * sum(v for k, v in by_span.items() if k is not None) / run.profile.window_s


def units(run) -> Optional[float]:
    """The traced slice's frames, or its groups of steps."""
    r = run.readings
    if r.get("traced_frames"):
        return r["traced_frames"]
    if r.get("traced_steps") and run.traffic.get("steps_per_dispatch"):
        return r["traced_steps"] / run.traffic["steps_per_dispatch"]
    return None


def self_ms(run, name: str) -> Optional[float]:
    """Host ms a traced frame or group spends in the spans `name`, less
    what their child spans cover."""
    recs, n = slice_records(run), units(run)
    if not recs or not n:
        return None
    own = tracing().self_times(recs)
    ids = [r.id for r in recs if r.name == name]
    return 1e3 * sum(own[i] for i in ids) / n if ids else None


def counter_share_pct(numerator: str, denominator: str) -> Optional[float]:
    """100 x one of the program's counters over another, or None."""
    module = tracing()
    if module is None:
        return None
    c = module.counters()
    return 100.0 * c.get(numerator, 0) / c[denominator] if c.get(denominator) else None
