"""The port's tracing (`utils/tracing.py`) on the CPU: spans nest with
their parent and request, self time, the bounded buffer, on only under a
profiler or `enable()`, never a profiler event; the spans of a
`map_chunks` frame of the fast renderer's kernel route (the kernels' plain
versions) and of the grouped training calls; `fast.rays_in_box` against a
direct count; the scene box on the device (`fast.box_resident`,
`fast.box_copies`): the clip bit-equal on every form of the box, and each
of the CLI's fast frame renderers reading its box on the device in every
tile, bit-equal to tiles handed the host box; the kernels' launch counts;
and, off, no clock read and no tensor operation that the program would
not run without tracing.
"""
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as k1
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.render import fast
from nerf_siren_tpu_torch.render.rendering import map_chunks
from nerf_siren_tpu_torch.training.system import NeRFSystem
from nerf_siren_tpu_torch.utils import tracing

FAST_STAGES = ["fast.clip", "fast.march", "fast.field", "fast.composite"]
BOX = ((-0.6, -0.5, -0.4), (0.5, 0.6, 0.4))


@pytest.fixture(autouse=True)
def clean():
    """Tracing off and empty around each test, on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    tracing.enable()
    yield
    tracing.disable()


def by_start(recs):
    return sorted(recs, key=lambda r: r.start)


# ---- spans ----------------------------------------------------------------------

def test_nesting_gives_parent_and_request(traced):
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        pass
    r = {x.name: x for x in tracing.records()}
    assert [x.name for x in tracing.records()] == ["c", "b", "d", "a", "e"]   # as they closed
    assert r["a"].parent is None and r["a"].request == r["a"].id
    assert r["b"].parent == r["a"].id and r["d"].parent == r["a"].id
    assert r["c"].parent == r["b"].id
    assert {r[k].request for k in "abcd"} == {r["a"].id}
    assert r["e"].parent is None and r["e"].request == r["e"].id
    assert all(x.start <= x.end for x in r.values())
    assert r["a"].start <= r["b"].start <= r["c"].start <= r["c"].end <= r["b"].end <= r["a"].end


def test_each_thread_has_its_own_stack(traced):
    """Two threads open spans while the main thread holds one open: each
    thread's spans have their own parents and requests."""
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(f"outer.{tag}"):
            barrier.wait()
            with tracing.span(f"inner.{tag}"):
                barrier.wait()

    with tracing.span("main"):
        threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    r = {x.name: x for x in tracing.records()}
    for t in "xy":
        assert r[f"outer.{t}"].parent is None and r[f"outer.{t}"].request == r[f"outer.{t}"].id
        assert r[f"inner.{t}"].parent == r[f"outer.{t}"].id
        assert r[f"inner.{t}"].request == r[f"outer.{t}"].id
    assert r["main"].parent is None


def test_self_time():
    rec = tracing.Record
    recs = [rec("child", 1.0, 2.0, 0, 0, 1), rec("grandchild", 2.5, 2.75, 2, 0, 3),
            rec("child", 2.5, 3.0, 0, 0, 2), rec("top", 0.0, 4.0, None, 0, 0),
            rec("other", 5.0, 6.5, None, 4, 4)]
    assert tracing.self_times(recs) == {0: 2.5, 1: 1.0, 2: 0.25, 3: 0.25, 4: 1.5}


def test_self_time_of_real_spans(traced):
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
    inner, outer = tracing.records()
    own = tracing.self_times(tracing.records())
    assert own[inner.id] == inner.end - inner.start
    assert own[outer.id] == pytest.approx((outer.end - outer.start) - (inner.end - inner.start))


def test_buffer_is_bounded(traced):
    for i in range(tracing.MAX_RECORDS + 5):
        with tracing.span("s"):
            pass
    recs = tracing.records()
    assert len(recs) == tracing.MAX_RECORDS
    assert recs[-1].id - recs[0].id == tracing.MAX_RECORDS - 1   # the oldest five dropped


def test_off_by_default():
    assert not tracing.on()
    assert tracing.span("a") is tracing.span("b")   # the shared no-op: nothing allocated
    with tracing.span("a"):
        tracing.count("n", 3)
        tracing.count_device("m", torch.ones(4, dtype=torch.bool))
    assert tracing.records() == []
    assert not {"n", "m"} & set(tracing.counters())


def test_on_under_a_profiler_and_enable_and_off_after():
    with torch.profiler.profile() as prof:
        assert tracing.on()
        with tracing.span("traced.by_profiler"):
            torch.ones(8).cumsum(0)
        tracing.count("n", 2)
    assert not tracing.on()
    with tracing.span("after.profiler"):
        pass
    tracing.enable()
    with tracing.span("traced.by_enable"):
        pass
    tracing.count("n", 5)
    tracing.disable()
    with tracing.span("after.enable"):
        pass
    tracing.count("n", 100)
    assert [r.name for r in tracing.records()] == ["traced.by_profiler", "traced.by_enable"]
    assert tracing.counters()["n"] == 7
    events = {e.name for e in prof.events()}
    assert "aten::cumsum" in events
    assert not {r.name for r in tracing.records()} & events   # no profiler annotation


def test_device_counter(traced):
    """Masks summed `FOLD` at a time and the rest when read: the same count."""
    mask = torch.tensor([True, False, True, True])
    tracing.count_device("hits", mask)
    tracing.count_device("hits", mask[:2])
    assert tracing.counters()["hits"] == 4
    for k in range(2 * tracing.FOLD + 3):
        tracing.count_device("hits", mask[: k % 5])
    want = 4 + sum(int(mask[: k % 5].sum()) for k in range(2 * tracing.FOLD + 3))
    assert tracing.counters()["hits"] == want
    tracing.count_device("other", mask)
    tracing.reset()
    assert not {"hits", "other"} & set(tracing.counters())


def test_launch_counts_count_through_tracing():
    """The kernels' `LAUNCHES` keep their module attributes and keys, and
    count through `tracing.count_launch` whether tracing is on or not."""
    assert set(k1.LAUNCHES) == {"sigma", "full", "sigma_wide", "full_wide"}
    assert set(k3.LAUNCHES) == {"opacity", "select", "opacity_scratch", "select_scratch"}
    assert k1.count_launch is k3.count_launch is tracing.count_launch
    before = dict(k1.LAUNCHES)
    tracing.count_launch(k1.LAUNCHES, "full")
    assert k1.LAUNCHES == {**before, "full": before["full"] + 1}
    k1.LAUNCHES["full"] -= 1


# ---- the fast renderer's frame ---------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    g = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    model = NeRF(NeRFConfig(depth=4, width=128))
    proxy = fast.init_proxy(hidden=32, generator=g)
    rng = np.random.default_rng(1)
    o = rng.normal(size=(300, 3))
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = -o + rng.normal(size=(300, 3)) * 1.5          # about half of them miss the box
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((300, 1), 2.0), np.full((300, 1), 6.0)], -1)
    return {"packed": k1.pack_model_params({"fine": model}),
            "proxy": k3.pack_proxy_params(proxy), "rays": torch.tensor(rays, dtype=torch.float32),
            "models": {"fine": model}, "proxy_module": proxy}


def fast_frame(scene, chunk=128):
    def tile(t):
        return fast.render_rays_fast(None, None, t, n_candidates=16, n_keep=8, select="pdf",
                                     scene_aabb=BOX, packed_params=scene["packed"],
                                     packed_proxy=scene["proxy"])
    with torch.no_grad():
        return map_chunks(tile, scene["rays"], chunk)


def test_fast_frame_spans(scene, traced):
    fast_frame(scene)   # 300 rays in chunks of 128: 3 chunks
    recs = by_start(tracing.records())
    assert [r.name for r in recs] == (["render.tiles"] + ["render.chunk", *FAST_STAGES] * 3
                                      + ["render.concat"])
    tiles = recs[0]
    chunks = [r for r in recs if r.name == "render.chunk"]
    assert all(r.request == tiles.id for r in recs)
    assert all(c.parent == tiles.id for c in chunks) and recs[-1].parent == tiles.id
    for c, stages in zip(chunks, (recs[2:6], recs[7:11], recs[12:16])):
        assert all(s.parent == c.id and c.start <= s.start <= s.end <= c.end for s in stages)
    assert tracing.counters()["fast.rays"] == 300


def test_rays_in_box_is_a_direct_count(scene, traced):
    fast_frame(scene)
    rays = scene["rays"].double().numpy()
    lo, hi = np.array(BOX[0]), np.array(BOX[1])
    with np.errstate(divide="ignore"):
        t_lo, t_hi = (lo - rays[:, :3]) / rays[:, 3:6], (hi - rays[:, :3]) / rays[:, 3:6]
    t_min = np.minimum(t_lo, t_hi).max(-1)
    t_max = np.maximum(t_lo, t_hi).min(-1)
    hits = int((t_max > np.maximum(t_min, 0.0)).sum())
    assert 0 < hits < 300
    c = tracing.counters()
    assert c["fast.rays_in_box"] == hits and c["fast.rays"] == 300


# ---- the scene box: held on the device by the frame renderers ---------------------

BOX_FORMS = {
    "tuple": lambda: BOX,
    "numpy": lambda: tuple(np.asarray(b, np.float32) for b in BOX),
    "tensor": lambda: fast.scene_box(BOX, torch.device("cpu")),
    "tensor_pair": lambda: tuple(torch.tensor(b, dtype=torch.float32) for b in BOX),
}


@pytest.mark.parametrize("form", list(BOX_FORMS))
def test_clip_takes_a_device_box_as_it_is_bit_equal_to_the_host_box(scene, form, traced):
    """`_clip_to_aabb` on every form of the box gives the host box's near,
    far and hits bit for bit, on rays that hit it and rays that miss it; a
    box of float32 tensors on the rays' device counts `fast.box_resident`,
    any other `fast.box_copies`."""
    rays = scene["rays"]
    args = rays[:, 0:3], rays[:, 3:6], rays[:, 6:7], rays[:, 7:8]
    want = fast._clip_to_aabb(*args, BOX)
    tracing.reset()
    got = fast._clip_to_aabb(*args, BOX_FORMS[form]())
    assert 0 < int(want[2].sum()) < rays.shape[0]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    resident = form.startswith("tensor")
    assert tracing.counters() == {"fast.box_resident" if resident else "fast.box_copies": 1}


def test_scene_box_is_the_host_box_in_float32():
    box = fast.scene_box(([-1.1, 0, 2.0 / 3.0], np.array([1, 2, 3])), torch.device("cpu"))
    assert box.dtype == torch.float32 and box.shape == (2, 3)
    assert torch.equal(box, torch.tensor([[-1.1, 0, 2.0 / 3.0], [1, 2, 3]], dtype=torch.float32))
    assert fast.scene_box(box, torch.device("cpu")) is box
    assert torch.equal(fast.scene_box(tuple(box.double()), torch.device("cpu")), box)


def test_direct_call_with_a_host_box_counts_one_copy(scene, traced):
    with torch.no_grad():
        fast.render_rays_fast(None, None, scene["rays"], n_candidates=16, n_keep=8,
                              select="pdf", scene_aabb=BOX, packed_params=scene["packed"],
                              packed_proxy=scene["proxy"])
    c = tracing.counters()
    assert c["fast.box_copies"] == 1 and "fast.box_resident" not in c


FAST_ROUTES = {   # eval CLI options of each fast frame renderer, and whether it runs on a mesh
    "defaults": ([], False),
    "adaptive": (["--fast_adaptive", "0.5", "12"], False),
    "cull": (["--fast_cull", "0.5"], False),
    "auto_cull": (["--fast_cull", "auto"], False),
    "mesh": ([], True),
    "auto_cull_mesh": (["--fast_cull", "auto"], True),
    "d3": (["--mode", "d3"], False),
}


def route_frames(scene, route, monkeypatch, host_box):
    """Two 300-ray frames in tiles of 128 through the CLI's fast renderer
    `route` (as eval.py's `make_fast_renderer` and `make_semantic_renderer`
    make it for the CLI; the auto-cull quantum TILE_R shrunk to 128 rays,
    so its frames are tiled too). host_box: every tile is handed the host box instead (`FastSetup.aabb`,
    copied each call), as before the renderers held it on the device.
    Returns the outputs, and the tracing counters and `fast.clip` spans of
    the two frames."""
    from nerf_siren_tpu_torch import eval as port_eval
    from nerf_siren_tpu_torch.models.pointnet import PointNetDenseCls
    from nerf_siren_tpu_torch.parallel.mesh import make_mesh

    flags, on_mesh = FAST_ROUTES[route]
    hp = port_eval.get_opts(["--root_dir", ".", "--ckpt_path", "x", "--renderer", "fast",
                             "--fast_candidates", "16", "--fast_keep", "8", "--chunk", "128",
                             *flags])
    aabb = tuple(np.asarray(b, np.float32) for b in BOX)
    setup = port_eval.FastSetup("fine", scene["proxy_module"], aabb, scene["packed"],
                                scene["proxy"])
    cfg = RenderConfig(chunk=128, test_time=True)
    mesh = make_mesh(devices=[torch.device("cpu")] * 2) if on_mesh else None
    models = dict(scene["models"])
    with monkeypatch.context() as m:
        m.setattr(fast, "TILE_R", 128)
        if host_box:
            m.setattr(port_eval, "fast_box", lambda models, fast_setup: fast_setup.aabb)
            m.setattr(fast, "scene_box", lambda box, device: box)
        if route == "d3":
            models["points"] = PointNetDenseCls(6, 6, generator=torch.Generator().manual_seed(5))
            render = port_eval.make_semantic_renderer(
                models, cfg, renderer="fast", n_classes=6, point_capacity=256,
                cls_threshold=0.0, fast=setup, hparams=hp)
        else:
            render = port_eval.make_fast_renderer(models, cfg, setup, hp, mesh=mesh)
        tracing.reset()
        tracing.enable()
        with torch.no_grad():
            outs = [render(scene["rays"]) for _ in range(2)]
        tracing.disable()
    clips = sum(r.name == "fast.clip" for r in tracing.records())
    return outs, tracing.counters(), clips


@pytest.mark.parametrize("route", list(FAST_ROUTES))
def test_frame_renderers_hold_the_box_on_the_device(scene, route, monkeypatch):
    """Each of the CLI's fast frame renderers puts the box on its devices
    once, when built: every tile reads it there (`fast.box_resident` once a
    tile, no `fast.box_copies`), and the frame equals, bit for bit, the one
    whose tiles are handed the host box and copy it each call."""
    got, counts, clips = route_frames(scene, route, monkeypatch, host_box=False)
    want, want_counts, want_clips = route_frames(scene, route, monkeypatch, host_box=True)
    assert clips == want_clips >= 6
    assert counts["fast.box_resident"] == clips and "fast.box_copies" not in counts
    assert want_counts["fast.box_copies"] == clips and "fast.box_resident" not in want_counts
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


# ---- the grouped training calls --------------------------------------------------

def tiny_system():
    torch.manual_seed(0)
    system = NeRFSystem(RenderConfig(n_samples=8, n_importance=0, perturb=1.0, noise_std=1.0),
                        TrainConfig(lr=5e-3, batch_size=64, decay_step=(100,)),
                        NeRFConfig(depth=2, width=32, skips=()), steps_per_epoch=10,
                        device="cpu")
    return system, system.init_state(0)


def tiny_rays(n):
    rng = np.random.default_rng(2)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)) * 0.2, d, np.full((n, 1), 2.0),
                           np.full((n, 1), 6.0)], -1).astype(np.float32)
    return rays, rng.uniform(size=(n, 3)).astype(np.float32)


def grouped_call(kind):
    system, state = tiny_system()
    rays, rgbs = tiny_rays(128)
    if kind == "batches":
        system.train_scan_batches(state, rays.reshape(2, 64, 8), rgbs.reshape(2, 64, 3), 1)
    elif kind == "pool":
        system.train_scan(state, rays, rgbs, 1, n_steps=2)
    else:
        system.train_scan_importance(state, rays, rgbs, 1, n_steps=2)


@pytest.mark.parametrize("kind", ["batches", "pool", "importance"])
def test_grouped_call_spans(kind, traced):
    grouped_call(kind)
    recs = by_start(tracing.records())
    assert [r.name for r in recs] == ["group", "group.h2d", "group.draws", "group.launch"]
    group = recs[0]
    assert all(r.parent == group.id and r.request == group.id for r in recs[1:])
    assert recs[1].end <= recs[2].start and recs[2].end <= recs[3].start


# ---- off: nothing the program would not do without tracing ---------------------

class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def op_log(fn):
    with OpLog() as log:
        fn()
    return log.ops


class NoClock:
    @staticmethod
    def perf_counter():
        raise AssertionError("tracing read the clock while off")


@pytest.mark.parametrize("what", ["fast frame", "grouped call"])
def test_off_no_clock_and_no_extra_operations(what, scene, monkeypatch):
    """Off, the traced code reads no clock, records nothing and runs the same
    tensor operations (no device work, no synchronisation: a read of a
    device value is an operation too) as with every tracing call made a
    no-op; on, the spans add no operation either (only the device
    counter does, and it is made a no-op for that comparison)."""
    run = (lambda: fast_frame(scene)) if what == "fast frame" else (lambda: grouped_call("pool"))
    with monkeypatch.context() as m:
        m.setattr(tracing, "time", NoClock)
        off = op_log(run)
    assert tracing.records() == [] and tracing.counters() == {}
    with monkeypatch.context() as m:
        m.setattr(tracing, "span", lambda name: tracing._OFF)
        m.setattr(tracing, "count", lambda *a: None)
        m.setattr(tracing, "count_device", lambda *a: None)
        without = op_log(run)
    assert off == without and len(off) > 50
    with monkeypatch.context() as m:
        m.setattr(tracing, "count_device", lambda *a: None)
        tracing.enable()
        on = op_log(run)
        tracing.disable()
    assert on == off
    assert tracing.records()
