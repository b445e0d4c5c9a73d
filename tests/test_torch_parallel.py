"""Sharded rendering of the port on one process and two devices, held
against JAX's on a 2-device mesh (two of the 8 virtual CPU devices of
tests/conftest.py) and against the port's one-device render; the
fingerprint; the data shards of `epoch_iterator` and `infinite_batches`;
the eval CLI on two slabs.

The port's mesh is the CPU twice (`Mesh.run` renders each slab from a host
thread of its own there too, the route of every mesh, under the caller's
grad mode).
Tolerances: outputs of the exact renderers within 1e-4 of JAX's (float32
on both sides, summation order only: tests/test_torch_rendering.py's bar),
the semantic class maps too; against the port's one-device render bit-equal wherever the slabs'
tiles are the one-device tiles (every per-ray computation is the same
op on the same rows); the auto-cull mesh mode within the fast renderer's
bars of tests/test_torch_fast_render.py (`close`), its per-shard budgets
and active fractions exactly JAX's, its eps within 1e-5 relative.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.parallel import mesh as jmesh
from nerf_siren_tpu.render import fast as jfast
from nerf_siren_tpu.render import triplane as J
from nerf_siren_tpu.render.rendering import render_rays as j_render_rays
from nerf_siren_tpu.training.eg3d_system import EG3DSystem as JEG3DSystem
from nerf_siren_tpu.training.semantic_system import NeRF3DSystem as JNeRF3DSystem
from nerf_siren_tpu.training.system import NeRFSystem as JNeRFSystem
from nerf_siren_tpu.training.system import epoch_iterator as j_epoch_iterator
from nerf_siren_tpu.utils.dnn import infinite_batches as j_infinite_batches
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.eval import make_renderer
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as k1
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.parallel import mesh as tmesh
from nerf_siren_tpu_torch.render import fast
from nerf_siren_tpu_torch.render.rendering import map_chunks, render_rays
from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig
from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem
from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem
from nerf_siren_tpu_torch.training.system import NeRFSystem, epoch_iterator
from nerf_siren_tpu_torch.utils.dnn import infinite_batches
from tests.test_torch_eg3d_eval import CFG as EG3D_CFG
from tests.test_torch_eg3d_eval import OPTS as EG3D_OPTS
from tests.test_torch_eg3d_eval import port_model as eg3d_port_model
from tests.test_torch_fast_render import _cull_frame, close, scene, small_tiles  # noqa: F401
from tests.test_torch_proxy_march import port_proxy, rays_np
from tests.test_torch_rendering import with_density
from tests.test_torch_semantic import _pointnet, numpy_tree, one_torch_thread  # noqa: F401
from tests.test_torch_stylegan2 import numpy_eg3d_tree

NARROW = dict(depth=4, width=32, skips=(2,))
RKW = dict(n_samples=8, n_importance=8, perturb=0.0, noise_std=0.0, white_back=True,
           test_time=True)
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def meshes():
    return jmesh.make_mesh(devices=jax.devices()[:2]), tmesh.make_mesh(
        devices=[torch.device("cpu")] * 2)


@pytest.fixture(scope="module")
def fields():
    params = {k: with_density(numpy_tree(init_nerf, JNeRFConfig(**NARROW), seed=s))
              for k, s in (("coarse", 1), ("fine", 2))}
    models = {}
    for k, p in params.items():
        models[k] = NeRF(NeRFConfig(**NARROW))
        models[k].load_state_dict(nerf_from_jax(p))
    return params, models


def _close(got, want, tol, what=""):
    assert set(got) >= set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), atol=tol, rtol=0,
                                   err_msg=f"{what} {k}")


def _equal(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what} {k}"


def test_mesh_slabs_and_replicas(meshes):
    """Contiguous slabs, one a device; a device that repeats shares one
    replica, which is the object itself on its own device."""
    _, mesh = meshes
    assert mesh.shape == {"data": 2} and mesh.size == 2
    x = torch.arange(12.0).reshape(6, 2)
    a, b = tmesh.shard_rays(x, mesh)
    assert torch.equal(a, x[:3]) and torch.equal(b, x[3:])
    model = NeRF(NeRFConfig(**NARROW))
    reps = tmesh.replicate({"m": model}, mesh)
    assert reps[0] is reps[1] and reps[0]["m"] is model
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_rays(torch.zeros(5, 2), mesh)
    with pytest.raises(SystemExit, match="CUDA cards are visible"):
        tmesh.mesh_devices("cuda", torch.cuda.device_count() + 1)


@pytest.mark.parametrize("chunk", [64, 100])
def test_sharded_tile_render_matches_jax_on_an_odd_ray_count(meshes, fields, chunk):
    """301 rays in two slabs padded to whole tiles (64: 3 tiles of 64 each;
    100: 2 of 100), a host thread a slab: JAX's `sharded_tile_render` of the
    same exact tile."""
    jm, tm = meshes
    params, models = fields
    rays = rays_np(301, seed=4)
    jcfg = JRenderConfig(**RKW)

    def jtile(t):
        return j_render_rays(params, t, jcfg, None, nerf_cfg=JNeRFConfig(**NARROW))

    want = jmesh.sharded_tile_render(jtile, jm, chunk)(jnp.asarray(rays))
    cfg = RenderConfig(**RKW)

    def tile(t):
        return render_rays(models, t, cfg, None)

    with torch.no_grad():
        got = tmesh.sharded_tile_render(tile, tm, chunk)(torch.from_numpy(rays))
        one = map_chunks(tile, torch.from_numpy(rays), chunk)
    _close(got, want, JAX_TOL, "sharded_tile_render")
    # the first slab's tiles are the one-device render's first tiles
    slab = -(-301 // (2 * chunk)) * chunk
    for k in one:
        assert torch.equal(got[k][:slab], one[k][:slab]), k
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad"])
def test_mesh_threads_take_the_callers_grad_mode(meshes, mode):
    """Each slab runs in a thread of its own, and PyTorch keeps the grad and
    inference modes per thread: `Mesh.run` hands the caller's to every slab."""
    _, tm = meshes
    seen = []

    def slab(x):
        seen.append((threading.get_ident(), torch.is_grad_enabled(),
                     torch.is_inference_mode_enabled()))
        return x

    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    with ctx():
        tm.run([slab, slab], [0, 1])
    assert len(seen) == 2 and threading.get_ident() not in {t for t, _, _ in seen}
    assert {(g, i) for _, g, i in seen} == {(mode == "grad", mode == "inference_mode")}


def test_exact_route_on_a_mesh_records_no_graph_under_no_grad(meshes, fields):
    """`eval`'s exact route over two slabs (a thread each) under no_grad, as
    the CLI renders it: no forward of a field in a slab records an autograd
    graph of its parameters (each slab would otherwise hold every chunk's
    activations until the frame ends), and the frame equals the one-device
    frame (1e-6: the slab boundary splits a tile). Under enabled grad the
    slabs record it."""
    _, tm = meshes
    _, models = fields
    cfg = RenderConfig(**RKW, chunk=64)
    rays = torch.from_numpy(rays_np(200, seed=6))
    two = make_renderer(models, cfg, renderer="exact", mesh=tm)
    graphs = []
    hooks = [m.register_forward_hook(lambda m, i, o: graphs.append(o.requires_grad))
             for m in models.values()]
    try:
        with torch.no_grad():
            got = two(rays)
        assert graphs and not any(graphs)
        graphs.clear()
        two(rays)
        assert graphs and all(graphs)
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        one = make_renderer(models, cfg, renderer="exact")(rays)
    assert got and all(v.grad_fn is None for v in got.values())
    for k in one:
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-6, rtol=1e-6)


def test_nerf_render_sharded_matches_jax_and_one_device(meshes, fields):
    jm, tm = meshes
    params, models = fields
    rays = rays_np(257, seed=5)
    rkw = {k: v for k, v in RKW.items() if k != "test_time"}
    jsys = JNeRFSystem(JRenderConfig(**rkw), JTrainConfig(), JNeRFConfig(**NARROW),
                       steps_per_epoch=1, mesh=jm)
    want = jsys.render_sharded(params, rays, test_time=True)
    system = NeRFSystem(RenderConfig(**rkw, chunk=64), TrainConfig(), NeRFConfig(**NARROW),
                        steps_per_epoch=1, device="cpu")
    got = system.render_sharded(models, rays, tm, test_time=True)
    _close(got, want, JAX_TOL, "render_sharded")
    one = system.render(models, rays, test_time=True)
    for k in one:
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-6, rtol=1e-6)


def test_semantic_render_sharded_matches_jax_and_one_device(meshes):
    """Each slab of 128 rays is tiled by chunk 64, one cloud a tile, as JAX's
    shards are; with slabs on whole tiles the one-device render builds the
    same clouds."""
    jm, tm = meshes
    rkw = {k: v for k, v in RKW.items() if k != "test_time"}
    nerf = dict(depth=2, width=32, skips=())
    jsys = JNeRF3DSystem(JRenderConfig(**rkw, chunk=64), JTrainConfig(loss_type="msenll"),
                         JNeRFConfig(**nerf), steps_per_epoch=1, mesh=jm,
                         semantic_network="pointnet", point_capacity=100)
    params = {k: with_density(numpy_tree(init_nerf, JNeRFConfig(**nerf), seed=s))
              for k, s in (("coarse", 3), ("fine", 4))}
    params["points"] = _pointnet()[0]
    rays = rays_np(256, seed=6)
    want = jsys.render_sharded(params, rays, test_time=False)
    system = NeRF3DSystem(RenderConfig(**rkw, chunk=64), TrainConfig(loss_type="msenll"),
                          NeRFConfig(**nerf), steps_per_epoch=1, point_capacity=100,
                          device="cpu")
    models = {"points": _pointnet()[1]}
    for k in ("coarse", "fine"):
        models[k] = NeRF(NeRFConfig(**nerf))
        models[k].load_state_dict(nerf_from_jax(params[k]))
    got = system.render_sharded(models, rays, tm)
    _close(got, want, JAX_TOL, "semantic render_sharded")
    _equal(got, system.render(models, rays), "one device")


def test_eg3d_render_sharded_matches_jax_and_one_device(meshes):
    """Planes synthesised once, the table and decoder on every slab's device,
    chunk 64: 200 rays in slabs of 100."""
    jm, tm = meshes
    jcfg = J.TriPlaneConfig(**EG3D_CFG, rendering=J.RenderingOptions(**EG3D_OPTS))
    tree = numpy_eg3d_tree(jcfg, seed=5, noise=True)
    jsys = JEG3DSystem(JRenderConfig(), JTrainConfig(), steps_per_epoch=1, mesh=jm,
                       triplane_cfg=jcfg)
    rays = rays_np(200, seed=7)
    rays[:, :3] += np.array([0.0, 0.0, -4.0], np.float32)
    rays[:, 3:6] = np.abs(rays[:, 3:6]) * np.array([0.2, 0.2, 1.0], np.float32)
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=-1, keepdims=True)
    want = jsys.render_sharded({"eg3d_renderer": tree}, rays, chunk=64)
    system = EG3DSystem(TriPlaneConfig(**EG3D_CFG, rendering=RenderingOptions(**EG3D_OPTS)),
                        device="cpu")
    model = eg3d_port_model(tree)
    got = system.render_sharded(model, torch.from_numpy(rays), tm, chunk=64)
    _close(got, want, JAX_TOL, "eg3d render_sharded")
    one = system.render(model, torch.from_numpy(rays), chunk=64)
    for k in one:   # slab 2's tiles start at ray 100, the one device's at 64 and 128
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-6, rtol=1e-6)


def test_auto_cull_mesh_mode_matches_jax(meshes, scene, monkeypatch):
    """`make_auto_cull_renderer(mesh=...)` against JAX's mesh mode over a
    sparse sequence whose foreground lies in one shard's slab: per-shard
    budgets (the maximum across shards sizes the next frame), each frame's
    active fraction, plain flag and per-shard eps, and the rays within the
    fast renderer's bars."""
    jm, tm = meshes
    monkeypatch.setattr(jpm, "TILE_R", 128)
    monkeypatch.setattr(fast, "TILE_R", 128)
    tree = jax.tree_util.tree_map(np.asarray, scene["tree"])
    tree = {"l1": tree["l1"], "l2": {"kernel": tree["l2"]["kernel"] * 0.3,
                                     "bias": tree["l2"]["bias"] + 1.0}}
    proxy = port_proxy(tree)
    kw = dict(n_candidates=8, n_keep=4, white_back=True, block=64)
    want_r = jfast.make_auto_cull_renderer(
        scene["params"], tree, nerf_cfg=jfast.NeRFConfig(depth=5, width=128),
        packed_params=jfm.pack_model_params(scene["params"],
                                            jfast.NeRFConfig(depth=5, width=128)),
        packed_proxy=jpm.pack_proxy_params(tree), mesh=jm, **kw)
    got_r = fast.make_auto_cull_renderer(
        None, proxy, packed_params=k1.pack_model_params(scene["models"]),
        packed_proxy=k3.pack_proxy_params(proxy), mesh=tm, **kw)
    frames = [(1, 2), (1, 2), (1, 2, 3)]   # 16 blocks of 64: shard 0 holds blocks 0-7
    trace = []
    for i, fg in enumerate(frames):
        rays = _cull_frame(fg, seed=30 + i)
        want = want_r(jnp.asarray(rays))
        with torch.no_grad():
            got = got_r(torch.from_numpy(rays))
        close(got, want, f"frame {i}")
        assert got_r.last_active_frac == want_r.last_active_frac, i
        assert got_r.last_plain == want_r.last_plain, i
        np.testing.assert_allclose([float(e) for e in got_r.last_eps],
                                   np.asarray(want_r.last_eps), rtol=1e-5, err_msg=str(i))
        trace.append(got_r.last_active_frac)
    assert trace[0] == 1.0 and min(trace) < 1.0, trace


def test_cross_replica_param_hash_equals_jax(fields):
    params, models = fields
    pts_tree, pts = _pointnet()
    want = float(jmesh.cross_replica_param_hash({**params, "points": pts_tree}))
    got = float(tmesh.cross_replica_param_hash({**models, "points": pts}))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tmesh.cross_replica_param_hash(params)) == float(
        tmesh.cross_replica_param_hash(models))


@pytest.mark.parametrize("shard", [0, 1])
def test_data_shards_equal_jax(shard):
    """`epoch_iterator` and `infinite_batches` at shard 0 and 1 of 2: JAX's
    rows (its interleaved shard and permutation); a batch that does not
    split raises JAX's error."""
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(101, 8)).astype(np.float32)
    rgbs = rng.uniform(size=(101, 3)).astype(np.float32)
    cls = rng.integers(0, 5, 101)
    kw = dict(shard_index=shard, num_shards=2)
    want = list(j_epoch_iterator(rays, rgbs, 16, 3, 2, {"cls": cls}, **kw))
    got = list(epoch_iterator(rays, rgbs, 16, 3, 2, {"cls": cls}, **kw))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="must divide evenly by the number of data shards"):
        list(epoch_iterator(rays, rgbs, 15, 3, 2, **kw))
    j_it = j_infinite_batches({"x": rays}, 8, seed=4, **kw)
    t_it = infinite_batches({"x": rays}, 8, seed=4, **kw)
    for _ in range(9):   # past the shard's end: a fresh permutation on both
        np.testing.assert_array_equal(next(t_it)["x"], next(j_it)["x"])


@pytest.mark.parametrize("rank", [0, 1])
def test_epoch_iterator_block_is_the_ranks_rows_of_the_one_process_batch(rank):
    """`train --num_chips 2`'s rank r reads `epoch_iterator(block=(r, 2))`:
    rows [8 r, 8 (r + 1)) of each one-process batch of 16 (extras too), as
    many batches; a batch that does not split raises JAX's error."""
    rng = np.random.default_rng(1)
    rays = rng.normal(size=(101, 8)).astype(np.float32)
    rgbs = rng.uniform(size=(101, 3)).astype(np.float32)
    extras = {"cls": rng.integers(0, 5, 101)}
    full = list(epoch_iterator(rays, rgbs, 16, 3, 2, extras))
    got = list(epoch_iterator(rays, rgbs, 16, 3, 2, extras, block=(rank, 2)))
    assert len(got) == len(full) == 6
    for a, b in zip(got, full):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k][8 * rank:8 * (rank + 1)])
    with pytest.raises(ValueError, match="must divide evenly by the number of data shards"):
        list(epoch_iterator(rays, rgbs, 15, 3, 2, block=(rank, 2)))


def test_eval_cli_on_two_slabs_writes_the_one_device_pngs(tmp_path):
    """`eval --device cpu --num_chips 2` renders each frame in two slabs and
    writes the PNGs of `--num_chips 1` byte for byte (the fused route, K1's
    plain version: every ray's outputs are the same computation)."""
    import json

    from nerf_siren_tpu_torch.eval import get_opts, main
    from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint
    from nerf_siren_tpu_torch.convert import nerf_to_jax
    from tests.datasets_synthetic import make_blender_dataset

    root = make_blender_dataset(str(tmp_path / "scene"), hw=16)
    gen = torch.Generator().manual_seed(0)
    trees = {name: nerf_to_jax(NeRF(NeRFConfig(), generator=gen).state_dict())
             for name in ("nerf_coarse", "nerf_fine")}
    ckpt = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(ckpt, trees)
    pngs = {}
    cwd = os.getcwd()
    for n in (1, 2):
        os.makedirs(tmp_path / f"run{n}")
        os.chdir(tmp_path / f"run{n}")
        try:
            main(get_opts(["--root_dir", root, "--ckpt_path", ckpt, "--img_wh", "16", "16",
                           "--N_samples", "8", "--N_importance", "8", "--chunk", "96",
                           "--device", "cpu", "--num_chips", str(n), "--split", "test"]))
        finally:
            os.chdir(cwd)
        out = tmp_path / f"run{n}" / "results" / "blender" / "test"
        pngs[n] = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))
                   if f.endswith(".png")}
    assert pngs[1] and pngs[1] == pngs[2], json.dumps(sorted(pngs[2]))


def test_eval_cli_refuses_edge_refinement_on_two_slabs():
    """JAX's refusal, before any data is read: the edge pass works on the
    whole image."""
    from nerf_siren_tpu_torch.eval import get_opts, main

    with pytest.raises(SystemExit, match="does not compose with --num_chips"):
        main(get_opts(["--root_dir", "unused", "--ckpt_path", "unused", "--device", "cpu",
                       "--num_chips", "2", "--renderer", "fast", "--fast_edge_refine", "0.04"]))


def test_launch_counts_lose_no_update_under_threads():
    """The kernel wrappers' counts take one lock: 8 threads (more than the
    cores a test worker gets) adding 20,000 each at a 1 us switch interval
    lose none, which a lost update would break."""
    import sys

    from nerf_siren_tpu_torch.ops.kernels._build import count_launch

    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(counts, "k")
                                                   for _ in range(20_000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 8 * 20_000
