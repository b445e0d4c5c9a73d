"""The readers of the program's own spans and counters (`metrics/_program.py`
and the files that call it): the clock alignment, self times per frame or
group and the idle attribution on a synthetic profile whose program spans
sit at a known offset from the trace's clock, with known gaps; then tiny
traced runs on the CPU in which each of these metrics reads a number."""
import types

import pytest
import torch

from benchmark import harness
from benchmark.metrics import _program

OFFSET = 1234.5   # trace seconds less perf_counter seconds
NEW_METRICS = {
    "nerf_blender.render_fast": ["fast_clip_ms", "fast_march_ms", "fast_field_ms",
                                 "fast_composite_ms", "box_hit_pct", "host_idle_pct.fast"],
    "nerf_blender.train": ["group_h2d_ms.train", "group_draws_ms.train", "host_idle_pct.train"],
    "eg3d_blender.train": ["group_h2d_ms.train", "group_draws_ms.train", "host_idle_pct.train"],
    "nerf_blender.render_exact": ["host_idle_pct.render"],
}


def us(t, jitter=0.0):
    """A perf_counter time on the trace's clock, in us."""
    return (t + OFFSET) * 1e6 + jitter


def synthetic_run(monkeypatch, frames=2):
    """Two frames on the host clock; the trace's annotations of the harness
    spans carry a few us of jitter; the device is idle in known gaps."""
    from nerf_siren_tpu_torch.utils import tracing

    rec = tracing.Record
    harness_spans = [("traced_slice", 100.0, 101.0)]
    program = []
    for f in range(frames):
        t = 100.0 + 0.4 * f
        harness_spans += [("frame_call", t + 0.1, t + 0.3), ("frame_sync", t + 0.3, t + 0.4)]
        i = 10 * f
        program += [rec("render.tiles", t + 0.11, t + 0.29, None, i, i),
                    rec("render.chunk", t + 0.12, t + 0.28, i, i, i + 1),
                    rec("fast.clip", t + 0.13, t + 0.15, i + 1, i, i + 2),
                    rec("fast.field", t + 0.16, t + 0.26, i + 1, i, i + 3)]
    program.append(rec("render.tiles", 99.0, 99.5, None, 99, 99))   # before the slice: left out
    notes = [(n, us(t0, j), us(t1, j)) for (n, t0, t1), j in
             zip(harness_spans, [3.0, -2.0, 1.0, 2.0, -1.0])]
    # device busy everywhere but: 5 ms in fast.clip (frame 0), 10 ms under
    # render.chunk alone (frame 0), 20 ms in frame_sync (frame 0, no program span)
    gaps = [(100.135, 100.140), (100.151, 100.161), (100.35, 100.37)]
    ops, t = [], 100.0
    for g0, g1 in gaps:
        ops.append(("k", us(t), us(g0)))
        t = g1
    ops.append(("k", us(t), us(101.0)))
    profile = harness.Profile(ops, notes, 1.0, (us(100.0, 3.0), us(101.0, 3.0)))
    run = harness.Run({"name": "x", "traffic": {}}, {}, 1, 1.0, True, torch.device("cpu"), 0.0,
                      profile=profile, readings={"traced_frames": frames})
    run.spans.records = harness_spans
    fake = types.SimpleNamespace(records=lambda: program, self_times=tracing.self_times,
                                 counters=lambda: {"fast.rays": 400, "fast.rays_in_box": 300})
    monkeypatch.setattr(_program, "tracing", lambda: fake)
    return run


def test_clock_offset_is_the_median_of_the_harness_spans(monkeypatch):
    run = synthetic_run(monkeypatch)
    assert _program.clock_offset(run) == pytest.approx(OFFSET + 1e-6, abs=1e-9)  # median jitter


def test_self_ms_per_frame(monkeypatch):
    run = synthetic_run(monkeypatch)
    assert _program.self_ms(run, "fast.clip") == pytest.approx(20.0)
    assert _program.self_ms(run, "fast.field") == pytest.approx(100.0)
    assert _program.self_ms(run, "render.chunk") == pytest.approx(160.0 - 120.0)
    assert _program.self_ms(run, "render.tiles") == pytest.approx(180.0 - 160.0)   # one frame
    assert _program.self_ms(run, "fast.march") is None


def test_idle_by_span_and_host_idle(monkeypatch):
    run = synthetic_run(monkeypatch)
    by_span = _program.idle_by_span(run)
    assert by_span.keys() == {"fast.clip", "render.chunk", None}
    assert by_span["fast.clip"] == pytest.approx(0.005, abs=1e-6)
    assert by_span["render.chunk"] == pytest.approx(0.010, abs=1e-6)
    assert by_span[None] == pytest.approx(0.020 + 3e-6, abs=1e-6)   # the slice ends 3 us late
    assert _program.host_idle_pct(run) == pytest.approx(1.5, abs=1e-3)
    device_idle = 100 * (1 - run.profile.busy_s() / run.profile.window_s)
    assert _program.host_idle_pct(run) <= device_idle


def test_units_of_a_group(monkeypatch):
    run = synthetic_run(monkeypatch)
    run.readings = {"traced_steps": 40}
    run.workload["traffic"] = {"steps_per_dispatch": 10}
    assert _program.units(run) == 4


def test_readers_of_the_new_metrics(monkeypatch):
    run = synthetic_run(monkeypatch)
    read = {name: harness.load_module(harness.metric_file(name), "m_" + name.replace(".", "_"))
            .read(run) for name in NEW_METRICS["nerf_blender.render_fast"]}
    assert read["fast_clip_ms"] == pytest.approx(20.0)
    assert read["fast_field_ms"] == pytest.approx(100.0)
    assert read["fast_march_ms"] is None and read["fast_composite_ms"] is None
    assert read["box_hit_pct"] == pytest.approx(75.0)
    assert read["host_idle_pct.fast"] == pytest.approx(1.5, abs=1e-3)


def test_no_tracing_module_reads_nothing(monkeypatch):
    """A program without the tracing module (the parent of this benchmark's
    readers) gives None, and no reader raises."""
    run = synthetic_run(monkeypatch)
    monkeypatch.setattr(_program, "tracing", lambda: None)
    for names in NEW_METRICS.values():
        for name in names:
            reader = harness.load_module(harness.metric_file(name), "m_" + name.replace(".", "_"))
            assert reader.read(run) is None


@pytest.mark.parametrize("cell", list(NEW_METRICS))
def test_tiny_traced_run_reads_every_new_metric(cell, tiny):
    from nerf_siren_tpu_torch.utils import tracing

    tracing.reset()
    run = harness.run_cell(cell, 2 ** 31 + 77, 0.2, True, torch.device("cpu"), tiny[cell])
    out = harness.result_line(run, harness.manifest(), cell, {"platform": "cpu", "count": 1})
    for name in NEW_METRICS[cell]:
        assert isinstance(out["metrics"][name]["value"], float), name
    assert not tracing.on()
