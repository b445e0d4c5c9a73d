"""The two-rank data-parallel runs behind tests/test_torch_data_parallel.py.

Imports torch and the port only: `torch.multiprocessing.spawn` starts each
rank afresh and imports this module there. `run(rank, world, store, out)`
joins a gloo group through a file store, runs every case on that rank and
saves its results to `<out>/rank<r>.pt`; the test module reads them once.
The same case functions with `dp=None` on the whole batches are the
one-process runs the tests hold the ranks against.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch
import torch.distributed as dist

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.training.system import NeRFSystem, parameters

NARROW = dict(depth=4, width=32, skips=(2,))
D3_NARROW = dict(depth=2, width=32, skips=())
TINY_TRI = dict(z_dim=32, w_dim=32, plane_resolution=16, plane_channels=8, mapping_layers=2,
                channel_base=512, channel_max=32)
EG3D_OPTS = dict(depth_resolution=8, depth_resolution_importance=8, ray_start=2.0,
                 ray_end=6.0, box_warp=8.0, white_back=True)
# SGD keeps an update linear in its gradient: the ranks' sum and the one
# process's differ only by float32 summation order (Adam's normalisation
# would turn a near-zero gradient's rounding into a whole step)
SGD = dict(optimizer="sgd", lr=5e-2, momentum=0.9, decay_step=(100,))
CULL = dict(culled_candidates=16, culled_sel=8, culled_uni=4)
BACKENDS = {"jnp": NARROW, "fused": {}, "culled_fused": {}}   # fused: K2's 8x256 field
STEPS, BATCH, SEED = 3, 16, 5
JAX_BATCH = 32


def rays_batch(n: int, seed: int):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.2, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    return {"rays": rays, "rgbs": rng.uniform(size=(n, 3)).astype(np.float32),
            "cls": rng.integers(0, 6, n).astype(np.int64)}


def local(batch, dp):
    """This rank's block of a global batch (all of it without a group)."""
    if dp is None:
        return batch
    per = len(batch["rays"]) // dp.world
    return {k: v[dp.rank * per:(dp.rank + 1) * per] for k, v in batch.items()}


def with_density(models):
    """Density along every ray (as tests/test_torch_rendering.py's
    `with_density`): no coarse weight is eps-floored."""
    with torch.no_grad():
        for k in ("coarse", "fine"):
            if k in models:
                models[k].sigma.bias += 0.5
    return models


def snapshot(state):
    return {f"{k}/{n}": p.detach().clone().numpy() for k, n, p in parameters(state.models)}


def nerf_system(backend, perturb, dp=None, **kw):
    rkw = dict(n_samples=8, n_importance=8, perturb=perturb, noise_std=perturb,
               white_back=True)
    extra = CULL if backend.startswith("culled") else {}
    return NeRFSystem(RenderConfig(**rkw), TrainConfig(**SGD), NeRFConfig(**BACKENDS[backend]),
                      steps_per_epoch=10, train_backend=backend, device="cpu",
                      data_parallel=dp, **extra, **kw)


def nerf_steps(backend, dp=None, perturb=1.0, n_steps=STEPS, batch=BATCH):
    """n_steps `train_step`s from seeded weights on seeded global batches."""
    system = nerf_system(backend, perturb, dp)
    state = system.init_state(SEED)
    with_density(state.models)
    metrics = []
    for i in range(n_steps):
        state, m = system.train_step(state, local(rays_batch(batch, 100 + i), dp), seed=7)
        metrics.append([float(m["train/loss"]), float(m["train/psnr"])])
    return {"params": snapshot(state), "metrics": np.array(metrics)}


def explicit_steps(dp):
    """`make_data_parallel_train_step` (JAX's `make_shard_map_train_step`)
    for STEPS steps at perturb 0 on the JAX_BATCH batches."""
    from nerf_siren_tpu_torch.parallel.shard_train import make_data_parallel_train_step

    system = nerf_system("jnp", 0.0)
    state = with_density_state(system.init_state(SEED))
    step = make_data_parallel_train_step(dp, system.optimizer, system.render_cfg)
    losses = []
    for i in range(STEPS):
        b = local(rays_batch(JAX_BATCH, 100 + i), dp)
        _, _, m = step(state.models, state.opt_state, torch.from_numpy(b["rays"]),
                       torch.from_numpy(b["rgbs"]))
        losses.append(float(m["train/loss"]))
    return {"params": snapshot(state), "metrics": np.array(losses)}


def eg3d_steps(dp=None, n_steps=2):
    from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig
    from nerf_siren_tpu_torch.training.eg3d_system import MODEL, EG3DSystem

    cfg = TriPlaneConfig(**TINY_TRI, rendering=RenderingOptions(**EG3D_OPTS))
    system = EG3DSystem(cfg, train_cfg=TrainConfig(**SGD), steps_per_epoch=10, device="cpu",
                        data_parallel=dp)
    state = system.init_state(SEED)
    metrics = []
    for i in range(n_steps):
        b = rays_batch(BATCH, 200 + i)
        b["rays"][:, :3] += np.array([0.0, 0.0, -4.0], np.float32)
        state, m = system.train_step(state, local(b, dp), seed=9)
        metrics.append([float(m["train/loss"]), float(m["train/psnr"])])
    mapping = state.models[MODEL].backbone.mapping
    return {"params": snapshot(state), "metrics": np.array(metrics),
            "w_avg": mapping.w_avg.detach().clone().numpy()}


def d3_system(dp=None, loss_type="msenll"):
    from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem

    rkw = dict(n_samples=8, n_importance=8, perturb=0.0, noise_std=0.0, white_back=True)
    return NeRF3DSystem(RenderConfig(**rkw), TrainConfig(loss_type=loss_type, **SGD),
                        NeRFConfig(**D3_NARROW), steps_per_epoch=10, point_capacity=64,
                        device="cpu", data_parallel=dp)


IGNORE_INDEX = {"msenll": -100, "msece": -1}
# rows whose labels are ignored: 5 of rank 0's 8 rows, 1 of rank 1's
IGNORED_ROWS = [0, 2, 3, 5, 6, 12]


def ignored_batch(loss_type):
    """The d3 step's batch with labels ignored unevenly over the two ranks'
    halves, so the ranks' masked means differ from the global one."""
    b = rays_batch(BATCH, 300)
    b["cls"][IGNORED_ROWS] = IGNORE_INDEX[loss_type]
    return b


def d3_step(dp=None, loss_type="msenll", ignored=False):
    """One d3 step: a cloud capacity (64) below the batch's 16 x 16 samples a
    pass, so the top-K cut runs over both ranks' rays; with `ignored`, on
    `ignored_batch`."""
    system = d3_system(dp, loss_type)
    state = with_density_state(system.init_state(SEED))
    batch = ignored_batch(loss_type) if ignored else rays_batch(BATCH, 300)
    state, m = system.train_step(state, local(batch, dp), seed=3)
    return {"params": snapshot(state),
            "metrics": np.array([float(m[k]) for k in ("train/total_loss", "train/rgb_loss",
                                                       "train/cls_loss", "train/psnr")])}


def with_density_state(state):
    with_density(state.models)
    return state


def grouped(dp):
    """3 grouped steps (StepGroup's CPU loop, the all-reduce in its body)
    and 3 eager steps from the same weights, seed and batches."""
    out = {}
    batches = [local(rays_batch(BATCH, 400 + i), dp) for i in range(3)]
    for kind in ("eager", "grouped"):
        system = nerf_system("jnp", 1.0, dp)
        state = with_density_state(system.init_state(SEED))
        if kind == "eager":
            for b in batches:
                state, m = system.train_step(state, b, seed=11)
        else:
            state, m = system.train_scan_batches(state, np.stack([b["rays"] for b in batches]),
                                                 np.stack([b["rgbs"] for b in batches]), seed=11)
        out[kind] = {"params": snapshot(state), "loss": float(m["train/loss"]),
                     "psnr": float(m["train/psnr"])}
    out["pool"] = pool_steps(dp)
    return out


def pool_steps(dp=None):
    """3 `train_scan` steps on a ray pool, BATCH rays a step over all ranks
    (each rank's indices are its rows of the global draw)."""
    system = nerf_system("jnp", 1.0, dp)
    state = with_density_state(system.init_state(SEED))
    pool = rays_batch(64, 500)
    world = 1 if dp is None else dp.world
    state, m = system.train_scan(state, pool["rays"], pool["rgbs"], seed=13, n_steps=3,
                                 batch_size=BATCH // world)
    return {"params": snapshot(state), "loss": float(m["train/loss"])}


def accum_steps(dp=None, n_steps=2):
    """2 `train_step_accum` updates (n_micro 2) at perturb 0 on JAX_BATCH
    global batches: each rank takes its rows of both micro-batches."""
    system = nerf_system("jnp", 0.0, dp)
    state = with_density_state(system.init_state(SEED))
    metrics = []
    for i in range(n_steps):
        b = rays_batch(JAX_BATCH, 600 + i)
        state, m = system.train_step_accum(state, {"rays": b["rays"], "rgbs": b["rgbs"]},
                                           seed=7, n_micro=2)
        metrics.append([float(m["train/loss"]), float(m["train/psnr"])])
    return {"params": snapshot(state), "metrics": np.array(metrics)}


def eg3d_system(dp=None):
    from nerf_siren_tpu_torch.render.triplane import RenderingOptions, TriPlaneConfig
    from nerf_siren_tpu_torch.training.eg3d_system import EG3DSystem

    cfg = TriPlaneConfig(**TINY_TRI, rendering=RenderingOptions(**EG3D_OPTS))
    return EG3DSystem(cfg, train_cfg=TrainConfig(**SGD), steps_per_epoch=10, device="cpu",
                      data_parallel=dp)


def importance_steps(dp=None, kind="nerf"):
    """3 `train_scan_importance` steps on a 64-ray pool, BATCH rays a step
    over all ranks: every rank draws the global batch's indices and keeps
    the whole error buffer, which the all-gathered errors update."""
    if kind == "nerf":
        system = nerf_system("jnp", 1.0, dp)
        state = with_density_state(system.init_state(SEED))
    else:
        system = eg3d_system(dp)
        state = system.init_state(SEED)
    pool = rays_batch(64, 700)
    if kind == "eg3d":
        pool["rays"][:, :3] += np.array([0.0, 0.0, -4.0], np.float32)
    world = 1 if dp is None else dp.world
    state, m = system.train_scan_importance(state, pool["rays"], pool["rgbs"], seed=17,
                                            n_steps=3, batch_size=BATCH // world,
                                            alpha=1.0, uniform_frac=0.2)
    return {"params": snapshot(state), "loss": float(m["train/loss"]),
            "buf": system.last_group.buf.numpy().copy()}


def utilities(dp):
    from nerf_siren_tpu_torch.utils import training_stats
    from nerf_siren_tpu_torch.utils.debug import check_replica_consistency

    moments = training_stats.report(training_stats.init_moments(),
                                    torch.arange(3.0) + 10 * dp.rank)
    summed = training_stats.cross_replica_sum(moments).numpy()
    system = nerf_system("jnp", 0.0)
    models = system.init_state(SEED).models
    equal_hash = check_replica_consistency(models)
    perturbed = copy.deepcopy(models)
    if dp.rank == 1:
        with torch.no_grad():
            perturbed["coarse"].xyz_layers[0].weight[0, 0] += 1e-3
    try:
        check_replica_consistency(perturbed)
        raised = False
    except AssertionError:
        raised = True
    return {"moments": summed, "equal_hash": equal_hash, "raised": raised}


def sharded_field(dp):
    """A 4x128 field under the model-axis plan, forward on both ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from nerf_siren_tpu_torch.models.nerf import NeRF
    from nerf_siren_tpu_torch.parallel import sharding

    cfg = NeRFConfig(depth=4, width=128, skips=(2,))
    plain = NeRF(cfg, generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(6)
    xyz = torch.from_numpy(rng.normal(size=(37, cfg.in_channels_xyz)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(37, cfg.in_channels_dir)).astype(np.float32))
    with torch.no_grad():
        want = plain(xyz, dirs)
        mesh = init_device_mesh("cpu", (dp.world,), mesh_dim_names=("model",))
        placements = sharding.nerf_param_placements(plain, dp.world)
        sharded = sharding.shard_module(copy.deepcopy(plain), mesh, placements)
        got = sharding.sharded_forward(sharded, mesh, xyz, dirs)
    specs = {n: sharding.jax_spec(placements[n], p.dim()) for n, p in plain.named_parameters()}
    local_shapes = {n: tuple(p.to_local().shape) for n, p in sharded.named_parameters()}
    return {"max_err": float((got - want).abs().max()), "scale": float(want.abs().max()),
            "specs": specs, "local_shapes": local_shapes}


def run(rank: int, world: int, store: str, out: str) -> None:
    from nerf_siren_tpu_torch.parallel.shard_train import DataParallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        dp = DataParallel()
        res = {f"nerf_{b}": nerf_steps(b, dp) for b in BACKENDS}
        res["nerf_jax"] = nerf_steps("jnp", dp, perturb=0.0, batch=JAX_BATCH)
        res["explicit"] = explicit_steps(dp)
        res["eg3d"] = eg3d_steps(dp)
        res["d3"] = d3_step(dp)
        for loss_type in IGNORE_INDEX:
            res[f"d3_ignored_{loss_type}"] = d3_step(dp, loss_type, ignored=True)
        res["grouped"] = grouped(dp)
        res["accum"] = accum_steps(dp)
        for kind in ("nerf", "eg3d"):
            res[f"importance_{kind}"] = importance_steps(dp, kind)
        res["utilities"] = utilities(dp)
        res["sharded_field"] = sharded_field(dp)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
