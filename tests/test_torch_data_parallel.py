"""Data-parallel training of the port on two gloo ranks, held against the
port's one-process steps and JAX's steps on a 2-device mesh.

`torch.multiprocessing.spawn` starts the two ranks ONCE for the module
(`ranks`, a file store under tmp_path, one torch thread each): they run
every case of `tests/torch_dp_worker.py` and save their results; each test
reads its part. Tolerances (float32 on both sides; SGD, so an update is
linear in its gradient and two runs differ only by summation order):
- port ranks vs the port's one process at perturb 1, noise 1 (3 steps of
  `jnp`, `fused` = K2's plain version, `culled_fused`; 2 EG3D steps): every
  parameter within 1e-5 + 1e-4 |ref| (`culled_fused` and EG3D 1e-5 + 1e-3
  |ref|: the proxy placement's and the synthesis' sums reorder), the
  step's loss and PSNR within a relative 1e-5 (1e-4);
- port ranks vs JAX's 2-device mesh step at perturb 0 (3 NeRF steps; one
  d3 step on JAX's global cloud): parameters within 1e-5 + 1e-4 |ref|,
  losses within a relative 1e-5;
- replicas: the two ranks' parameters byte-equal, grouped steps bit-equal
  to eager ones (the same ops on the same draws).
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.parallel.mesh import make_mesh, replicate, shard_rays
from nerf_siren_tpu.parallel.shard_train import make_shard_map_train_step
from nerf_siren_tpu.parallel.sharding import nerf_param_sharding
from nerf_siren_tpu.training.semantic_system import NeRF3DSystem as JNeRF3DSystem
from nerf_siren_tpu.training.system import NeRFSystem as JNeRFSystem
from nerf_siren_tpu.training.system import TrainState as JTrainState
from nerf_siren_tpu_torch.convert import nerf_to_jax, points_to_jax, to_jax
from nerf_siren_tpu_torch.parallel.mesh import cross_replica_param_hash
from tests import torch_dp_worker as W
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

PARAM_TOL = (1e-5, 1e-4)       # atol, rtol
LOOSE_TOL = (1e-5, 1e-3)       # culled_fused and EG3D
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    mp.spawn(W.run, args=(2, os.path.join(out, "store"), out), nprocs=2, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in (0, 1)]


def _close_params(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol[0], rtol=tol[1],
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("backend", list(W.BACKENDS))
def test_nerf_ranks_equal_the_one_process_steps(ranks, backend):
    """Two ranks at perturb 1 and noise 1: each draws the global batch's
    noise and keeps its rows, so they take the one-process steps."""
    one = W.nerf_steps(backend)
    got = ranks[0][f"nerf_{backend}"]
    tol = LOOSE_TOL if backend.startswith("culled") else PARAM_TOL
    _close_params(got["params"], one["params"], tol, backend)
    np.testing.assert_allclose(got["metrics"], one["metrics"],
                               rtol=10 * METRIC_RTOL if backend.startswith("culled")
                               else METRIC_RTOL)


def _jax_params(models):
    return {k: (points_to_jax if k == "points" else nerf_to_jax)(m.state_dict())
            for k, m in models.items()}


def _jax_nerf_start():
    system = W.nerf_system("jnp", 0.0)
    return W.with_density_state(system.init_state(W.SEED)), system


def _rkw():
    return dict(n_samples=8, n_importance=8, perturb=0.0, noise_std=0.0, white_back=True)


def _from_jax(params, like):
    from nerf_siren_tpu_torch.convert import nerf_from_jax, points_from_jax

    out = {}
    for k, tree in params.items():
        sd = (points_from_jax if k == "points" else nerf_from_jax)(
            jax.tree_util.tree_map(np.asarray, tree))
        out.update({f"{k}/{n}": v.numpy() for n, v in sd.items()})
    return {k: out[k] for k in like}


def test_nerf_ranks_equal_jax_mesh_steps(ranks):
    """3 steps at perturb 0: the ranks against JAX's NeRFSystem on a 2-device
    mesh (jit's global batch, its gradient psum)."""
    state, _ = _jax_nerf_start()
    params = _jax_params(state.models)
    mesh = make_mesh(devices=jax.devices()[:2])
    jsys = JNeRFSystem(JRenderConfig(**_rkw()), JTrainConfig(**W.SGD),
                       JNeRFConfig(**W.NARROW), steps_per_epoch=10, mesh=mesh)
    jstate = replicate(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jsys.tx.init(params)), mesh)
    losses = []
    for i in range(W.STEPS):
        b = W.rays_batch(W.JAX_BATCH, 100 + i)
        jstate, m = jsys.train_step(jstate, {"rays": b["rays"], "rgbs": b["rgbs"]},
                                    jax.random.PRNGKey(0))
        losses.append(float(m["train/loss"]))
    got = ranks[0]["nerf_jax"]
    _close_params(got["params"], _from_jax(jstate.params, got["params"]), PARAM_TOL, "jax")
    np.testing.assert_allclose(got["metrics"][:, 0], losses, rtol=METRIC_RTOL)


def test_explicit_step_equals_jax_shard_map_step(ranks):
    """`make_data_parallel_train_step` on two ranks against JAX's
    `make_shard_map_train_step` on a 2-device mesh, 3 steps at perturb 0."""
    state, system = _jax_nerf_start()
    params = _jax_params(state.models)
    mesh = make_mesh(devices=jax.devices()[:2])
    jsys = JNeRFSystem(JRenderConfig(**_rkw()), JTrainConfig(**W.SGD),
                       JNeRFConfig(**W.NARROW), steps_per_epoch=10, mesh=mesh)
    step = make_shard_map_train_step(mesh, jsys.tx, jsys.render_cfg.replace(test_time=False),
                                     JNeRFConfig(**W.NARROW))
    p, o = replicate(params, mesh), replicate(jsys.tx.init(params), mesh)
    losses = []
    for i in range(W.STEPS):
        b = shard_rays({k: jnp.asarray(v) for k, v in W.rays_batch(W.JAX_BATCH, 100 + i).items()
                        if k != "cls"}, mesh)
        p, o, m = step(p, o, b["rays"], b["rgbs"], None)
        losses.append(float(m["train/loss"]))
    got = ranks[0]["explicit"]
    _close_params(got["params"], _from_jax(p, got["params"]), PARAM_TOL, "shard_map")
    np.testing.assert_allclose(got["metrics"], losses, rtol=METRIC_RTOL)


def test_replicas_are_byte_equal(ranks):
    """Every case leaves both ranks' parameters byte-equal (one all-reduce
    result on both), and so their fingerprints."""
    for case in ("nerf_jnp", "nerf_fused", "nerf_culled_fused", "nerf_jax", "explicit",
                 "eg3d", "d3", "d3_ignored_msenll", "d3_ignored_msece", "accum",
                 "importance_nerf", "importance_eg3d"):
        a, b = ranks[0][case]["params"], ranks[1][case]["params"]
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (case, k)
        assert float(cross_replica_param_hash(a)) == float(cross_replica_param_hash(b)), case
    np.testing.assert_array_equal(ranks[0]["eg3d"]["w_avg"], ranks[1]["eg3d"]["w_avg"])


def test_eg3d_ranks_equal_the_one_process_steps(ranks):
    """2 EG3D steps (the stochastic strata and pdf drawn at the global
    batch's shape, the replicated synthesis, the w_avg EMA)."""
    one = W.eg3d_steps()
    got = ranks[0]["eg3d"]
    _close_params(got["params"], one["params"], LOOSE_TOL, "eg3d")
    np.testing.assert_allclose(got["w_avg"], one["w_avg"], atol=LOOSE_TOL[0],
                               rtol=LOOSE_TOL[1])
    np.testing.assert_allclose(got["metrics"], one["metrics"], rtol=10 * METRIC_RTOL)
    assert not np.array_equal(got["w_avg"], W.eg3d_steps(n_steps=0)["w_avg"])


def test_d3_ranks_equal_jax_mesh_step_on_the_global_cloud(ranks):
    """One d3 step, a cloud capacity below the batch's samples: the ranks
    all-gather the per-ray inputs and hold JAX's one cloud of the global
    batch (on a 2-device mesh), so the point network's update is JAX's."""
    system = W.d3_system()
    state = W.with_density_state(system.init_state(W.SEED))
    params = _jax_params(state.models)
    mesh = make_mesh(devices=jax.devices()[:2])
    jsys = JNeRF3DSystem(JRenderConfig(**_rkw()), JTrainConfig(loss_type="msenll", **W.SGD),
                         JNeRFConfig(**W.D3_NARROW), steps_per_epoch=10, mesh=mesh,
                         semantic_network="pointnet", point_capacity=64)
    jstate = replicate(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jsys.tx.init(params)), mesh)
    jstate, m = jsys.train_step(jstate, W.rays_batch(W.BATCH, 300), jax.random.PRNGKey(0))
    got = ranks[0]["d3"]
    _close_params(got["params"], _from_jax(jstate.params, got["params"]), PARAM_TOL, "d3")
    np.testing.assert_allclose(got["metrics"][:3], [float(m[k]) for k in (
        "train/total_loss", "train/rgb_loss", "train/cls_loss")], rtol=METRIC_RTOL)
    # the per-rank cloud is another function: the global gather matters here
    one_rank = W.d3_system()
    s1 = W.with_density_state(one_rank.init_state(W.SEED))
    half = {k: v[:W.BATCH // 2] for k, v in W.rays_batch(W.BATCH, 300).items()}
    s1, _ = one_rank.train_step(s1, half, seed=3)
    local = W.snapshot(s1)
    assert any(not np.allclose(local[k], got["params"][k], atol=1e-6)
               for k in local if k.startswith("points/"))


@pytest.mark.parametrize("loss_type", list(W.IGNORE_INDEX))
def test_d3_ranks_take_jax_global_masked_mean_over_uneven_ignored_labels(ranks, loss_type):
    """One d3 step whose labels are ignored unevenly over the ranks (5 of
    rank 0's 8 rows, 1 of rank 1's): the ranks divide their masked sums by
    the global count (`DataParallel.mean_count`), so their step is JAX's
    one global masked mean on a 2-device mesh, at the bars of the d3 test
    above."""
    system = W.d3_system(loss_type=loss_type)
    state = W.with_density_state(system.init_state(W.SEED))
    params = _jax_params(state.models)
    mesh = make_mesh(devices=jax.devices()[:2])
    jsys = JNeRF3DSystem(JRenderConfig(**_rkw()), JTrainConfig(loss_type=loss_type, **W.SGD),
                         JNeRFConfig(**W.D3_NARROW), steps_per_epoch=10, mesh=mesh,
                         semantic_network="pointnet", point_capacity=64)
    jstate = replicate(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jsys.tx.init(params)), mesh)
    jstate, m = jsys.train_step(jstate, W.ignored_batch(loss_type), jax.random.PRNGKey(0))
    got = ranks[0][f"d3_ignored_{loss_type}"]
    _close_params(got["params"], _from_jax(jstate.params, got["params"]), PARAM_TOL,
                  f"d3 {loss_type}")
    np.testing.assert_allclose(got["metrics"][:3], [float(m[k]) for k in (
        "train/total_loss", "train/rgb_loss", "train/cls_loss")], rtol=METRIC_RTOL)


def test_grouped_steps_with_the_all_reduce_equal_eager_steps(ranks):
    """`train_scan_batches` on StepGroup's CPU route, its body's all-reduce
    included, is bit-equal to as many eager data-parallel steps."""
    for r in ranks:
        eager, grouped = r["grouped"]["eager"], r["grouped"]["grouped"]
        for k in eager["params"]:
            np.testing.assert_array_equal(grouped["params"][k], eager["params"][k], err_msg=k)
        assert (grouped["loss"], grouped["psnr"]) == (eager["loss"], eager["psnr"])


def test_pool_steps_equal_the_one_process_steps(ranks):
    """`train_scan` on a replicated ray pool: each rank takes its rows of
    the step's global index draw, so two ranks of 8 rays take the
    one-process steps of 16."""
    one = W.pool_steps()
    got = ranks[0]["grouped"]["pool"]
    _close_params(got["params"], one["params"], PARAM_TOL, "pool")
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=METRIC_RTOL)


def test_accum_ranks_equal_jax_mesh_accum(ranks):
    """2 `train_step_accum` updates (n_micro 2, perturb 0, noise 0): the
    ranks, each on its rows of every micro-batch with one all-reduce before
    the update, against JAX's accumulated step on a 2-device mesh
    (`shard_batched`'s layout). Parameters within 1e-5 + 1e-4 |ref|, loss
    and PSNR within a relative 1e-5."""
    state, _ = _jax_nerf_start()
    params = _jax_params(state.models)
    mesh = make_mesh(devices=jax.devices()[:2])
    jsys = JNeRFSystem(JRenderConfig(**_rkw()), JTrainConfig(**W.SGD),
                       JNeRFConfig(**W.NARROW), steps_per_epoch=10, mesh=mesh)
    jstate = replicate(JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   opt_state=jsys.tx.init(params)), mesh)
    metrics = []
    for i in range(2):
        b = W.rays_batch(W.JAX_BATCH, 600 + i)
        jstate, m = jsys.train_step_accum(jstate, {"rays": b["rays"], "rgbs": b["rgbs"]},
                                          jax.random.PRNGKey(0), n_micro=2)
        metrics.append([float(m["train/loss"]), float(m["train/psnr"])])
    got = ranks[0]["accum"]
    _close_params(got["params"], _from_jax(jstate.params, got["params"]), PARAM_TOL, "accum")
    np.testing.assert_allclose(got["metrics"], metrics, rtol=METRIC_RTOL)


@pytest.mark.parametrize("kind", ["nerf", "eg3d"])
def test_importance_ranks_equal_the_one_process_scan(ranks, kind):
    """3 `train_scan_importance` steps on a 64-ray pool at perturb 1 (EG3D:
    its stochastic strata and pdf): two ranks of 8 rays against the one
    process's scan of 16 at the same seed (jax.random's categorical cannot
    be replayed, so the port's one-process scan is the reference).
    Parameters within PARAM_TOL (EG3D LOOSE_TOL), the loss within a relative
    1e-5 (EG3D 1e-4); both ranks' error buffers byte-equal, and equal to
    the one process's within the parameter bar."""
    one = W.importance_steps(None, kind)
    got = ranks[0][f"importance_{kind}"]
    tol = PARAM_TOL if kind == "nerf" else LOOSE_TOL
    _close_params(got["params"], one["params"], tol, f"importance {kind}")
    np.testing.assert_allclose(got["loss"], one["loss"],
                               rtol=METRIC_RTOL if kind == "nerf" else 10 * METRIC_RTOL)
    assert ranks[0][f"importance_{kind}"]["buf"].tobytes() == \
        ranks[1][f"importance_{kind}"]["buf"].tobytes()
    np.testing.assert_allclose(got["buf"], one["buf"], atol=tol[0], rtol=tol[1])
    assert (got["buf"] != 1.0).any()   # the steps wrote errors


def test_initialize_distributed_asks_for_a_card_by_default(monkeypatch):
    """Without `device_type`, `initialize_distributed` asks for CUDA and,
    where no card is visible (here), raises naming `--device cpu` before
    it joins anything."""
    import torch.distributed as dist

    from nerf_siren_tpu_torch.parallel import multihost

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        multihost.initialize_distributed("file:///nonexistent/store", 1, 0)
    assert not dist.is_initialized()


def test_cross_replica_sum(ranks):
    """Moments of [0, 1, 2] and [10, 11, 12]: count 6, sum 36, squares 370
    on both ranks."""
    for r in ranks:
        np.testing.assert_array_equal(r["utilities"]["moments"], [6.0, 36.0, 370.0])


def test_check_replica_consistency_raises_on_a_perturbed_replica(ranks):
    for r in ranks:
        assert r["utilities"]["raised"]
    assert ranks[0]["utilities"]["equal_hash"] == ranks[1]["utilities"]["equal_hash"]


def test_model_axis_plan_splits_jax_dims(ranks):
    """The placements name JAX's `nerf_param_sharding` specs on a model
    axis of 2, and each rank holds half of every split dim."""
    from nerf_siren_tpu.models.nerf import init_nerf

    got = ranks[0]["sharded_field"]
    cfg = JNeRFConfig(depth=4, width=128, skips=(2,))
    params = jax.eval_shape(lambda k: init_nerf(k, cfg), jax.random.PRNGKey(0))
    mesh = make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2])
    want = nerf_param_sharding(mesh, params)
    names = {"kernel": "weight", "bias": "bias"}
    for i in range(4):
        for leaf, tname in names.items():
            spec = tuple(want["xyz_layers"][i][leaf].spec)
            while spec and spec[-1] is None:
                spec = spec[:-1]
            assert got["specs"][f"xyz_layers.{i}.{tname}"] == spec, (i, leaf)
    for head in ("xyz_final", "sigma", "dir_layer", "rgb"):
        for leaf, tname in names.items():
            assert tuple(want[head][leaf].spec) == () == got["specs"][f"{head}.{tname}"]
    assert got["local_shapes"]["xyz_layers.0.weight"] == (64, 63)
    assert got["local_shapes"]["xyz_layers.1.weight"] == (128, 64)


def test_model_axis_forward_equals_the_plain_forward(ranks):
    """A 4x128 field sharded on a model axis of 2 ranks: the forward within
    1e-6 of its largest output (float32; the row-parallel layers' partial
    sums are added in another order)."""
    for r in ranks:
        f = r["sharded_field"]
        assert f["max_err"] <= 1e-6 * max(f["scale"], 1.0)


def test_train_cli_on_two_ranks_writes_the_one_process_checkpoint(tmp_path):
    """`train --device cpu --num_chips 2` (two spawned gloo ranks, each on
    its rows of every batch) against `--num_chips 1`: rank 0 alone writes,
    one checkpoint, whose weights are the one process's within the
    parameter bar above (SGD, 2 steps)."""
    import glob

    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.train import main
    from nerf_siren_tpu_torch.training.checkpoints import load_checkpoint
    from tests.datasets_synthetic import make_blender_dataset

    root = make_blender_dataset(str(tmp_path / "scene"), hw=8)
    # 6 train images of 8x8 = 384 rays: 2 steps of 192 rays
    args = ["--root_dir", root, "--dataset_name", "blender", "--img_wh", "8", "8",
            "--N_samples", "8", "--N_importance", "8", "--batch_size", "192",
            "--optimizer", "sgd", "--lr", "5e-2", "--num_epochs", "1", "--device", "cpu"]
    trees = {}
    cwd = os.getcwd()
    for n in (1, 2):
        run = tmp_path / f"run{n}"
        run.mkdir()
        os.chdir(run)
        try:
            main(get_opts(args + ["--num_chips", str(n)]))
        finally:
            os.chdir(cwd)
        (path,) = glob.glob(str(run / "ckpts" / "exp" / "*.msgpack"))
        assert os.path.basename(path) == "epoch=0-step=2.msgpack"
        assert len(glob.glob(str(run / "logs" / "exp" / "*"))) <= 1   # one writer at most
        trees[n] = load_checkpoint(path)["params"]
    flat = {n: dict(jax.tree_util.tree_leaves_with_path(t)) for n, t in trees.items()}
    assert set(flat[1]) == set(flat[2])
    for k, want in flat[1].items():
        np.testing.assert_allclose(np.asarray(flat[2][k]), np.asarray(want),
                                   atol=PARAM_TOL[0], rtol=PARAM_TOL[1], err_msg=str(k))


def test_multihost_reads_jax_env_names_and_trains_a_one_process_group(tmp_path, monkeypatch):
    """`train --multihost` joins the group JAX's NERF_TPU_* names describe
    (here one gloo process on a file store); without them and without
    torchrun's it refuses, naming them. A group of one trains the
    one-process path (no collective) and rank 0 writes its checkpoint."""
    import glob

    import torch.distributed as dist

    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.parallel import multihost
    from nerf_siren_tpu_torch.train import main
    from tests.datasets_synthetic import make_blender_dataset

    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "NERF_TPU_COORDINATOR",
                 "NERF_TPU_NUM_PROCESSES", "NERF_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="NERF_TPU_COORDINATOR"):
        multihost.initialize_distributed(device_type="cpu")
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    monkeypatch.setenv("NERF_TPU_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("NERF_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("NERF_TPU_PROCESS_ID", "0")
    root = make_blender_dataset(str(tmp_path / "scene"), hw=8)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        state = main(get_opts(["--root_dir", root, "--img_wh", "8", "8", "--N_samples", "4",
                               "--N_importance", "4", "--batch_size", "192", "--num_epochs",
                               "1", "--device", "cpu", "--multihost"]))
        assert dist.is_initialized() and multihost.is_primary()
        assert multihost.local_device("cpu") == torch.device("cpu")
    finally:
        os.chdir(cwd)
        if dist.is_initialized():
            dist.destroy_process_group()
    assert state.step == 2
    assert len(glob.glob(str(tmp_path / "ckpts" / "exp" / "*.msgpack"))) == 1
