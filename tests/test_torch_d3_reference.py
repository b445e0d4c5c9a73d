"""The port's semantic training step (`NeRF3DSystem`, `--mode d3`, PointNet)
against the benchmark's plain reference (`benchmark/reference/nerf3d.py`:
PointNet on the gathered valid points alone, no capacity and no mask) on
the CPU at a small size, on seeded random weights (a dense ball of
density for the frozen fields, so that some weights pass 0.5): the
composited class log-probabilities at thresholds 0 and 0.5 with the
capacity at rays x samples, the loss, the point network's gradients and one Adam step; and
the benchmark cell's check at a tiny size, where a capacity below the
valid count fails it and the whole cloud passes.

Tolerances and why (float32 on both sides; sums in another order: masked
sums over every slot against sums over the valid points, the fork's
BatchNorm against `masked_bn`):
- cls: relative gap of norms 1e-5 (measured 5e-7 - 1e-6): the forward's
  rounding alone.
- loss: relative 1e-6 (measured 0: its rgb share, the same frozen fields,
  dominates).
- gradients of the parts that learn (`reference/nerf3d.py::learning`):
  each leaf within 2e-3 of the largest leaf's norm (measured 1.0e-4):
  BatchNorm's backward cancels most of what reaches it, which leaves
  rounding a larger share than in the forward. The other parts get
  rounding alone on either side and are not compared.
- one Adam step: each learning leaf's change within 1e-3 of its norm on
  the weights whose reference gradient is at least 5% of the leaf's
  largest (24% of them; dead ReLU units leave whole rows at 0; measured
  0.9e-4 on eight torch threads, 2.2e-4 on one). The first step is
  lr g / (|g| + eps) a weight, so a weight whose gradient lies within the
  gradients' rounding of zero steps its full lr either way (one such
  weight moved feat.conv1's change by 9% on one torch thread).
"""
import json

import pytest
import torch

from benchmark import harness, scenes
from benchmark.models import nerf as bench_nerf
from benchmark.models import nerf3d as bench_nerf3d
from benchmark.reference import nerf as ref_nerf
from benchmark.reference import nerf3d as ref
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.render.rendering_3d import render_rays_3d
from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem, make_points_network
from nerf_siren_tpu_torch.training.system import parameters
from nerf_siren_tpu_torch.utils import tracing
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
CFG = {"depth": 4, "width": 32, "skips": [2], "xyz_freqs": 10, "dir_freqs": 4, "dir_width": 16,
       "n_samples": 16, "n_importance": 16, "near": 2.0, "far": 6.0, "white_back": True,
       "n_classes": 6, "point_inputs": 6}
CAMS = {"count": 2, "width": 12, "height": 12, "camera_angle_x": 0.69, "radius": 4.0,
        "elevation_deg": [5, 85], "near": 2.0, "far": 6.0}
SEED, LR = 2 ** 31 + 303, 5e-4


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    g = scenes.torch_generator(SEED, CPU, 0)
    # a dense ball: a few fine samples pass 0.5 too (the fork's BatchNorm
    # refuses a cloud of one point)
    weights = {f: ref_nerf.ball_field(CFG, g, sigma=80.0) for f in ("coarse", "fine")}
    weights["points"] = ref.random_pointnet(6, 6, g)
    rays = scenes.frame_rays(CAMS, SEED, CPU).reshape(-1, 8)
    labels = torch.randint(0, 6, (rays.shape[0],), generator=torch.Generator().manual_seed(1))
    rgbs = torch.rand(rays.shape[0], 3, generator=torch.Generator().manual_seed(2))
    draws = ref_nerf.step_draws(SEED, 0, rays.shape[0], CFG, 1.0, 1.0, CPU)
    return weights, rays, rgbs, labels, draws


def program_models(weights):
    models = bench_nerf.program_models(CFG, weights, CPU)
    models["points"] = make_points_network("pointnet", 6)
    models["points"].load_state_dict(weights["points"])
    return models


def render_cfg():
    return RenderConfig(n_samples=16, n_importance=16, perturb=1.0, noise_std=1.0,
                        white_back=True)


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_cls_equals_the_reference_with_every_sample(setup, threshold):
    weights, rays, _, _, draws = setup
    r = rays.shape[0]
    with torch.no_grad():
        got = render_rays_3d(program_models(weights), rays, render_cfg(), noise=draws,
                             point_capacity=r * 32, cls_threshold=threshold)
        want = ref.render(weights["coarse"], weights["fine"], weights["points"], CFG, rays,
                          ref.operand_round("fp32"), draws, threshold)
    for p in ("coarse", "fine"):
        assert rel(got[f"cls_{p}"], want[f"cls_{p}"]) < 1e-5, p
        assert torch.equal(got[f"rgb_{p}"], want[f"rgb_{p}"]) or \
            rel(got[f"rgb_{p}"], want[f"rgb_{p}"]) < 1e-6
    if threshold == 0.5:   # some samples pass 0.5, and the cloud is smaller than at 0
        assert (want["cls_fine"] != 0).any()


def system_for(r):
    train_cfg = TrainConfig(loss_type="msenll", lr=LR, batch_size=r)
    nerf_cfg = NeRFConfig(depth=4, width=32, skips=(2,))
    return NeRF3DSystem(render_cfg(), train_cfg, nerf_cfg, steps_per_epoch=100,
                        point_capacity=r * 32, device="cpu")


def test_loss_gradients_and_one_adam_step_equal_the_reference(setup):
    weights, rays, rgbs, labels, draws = setup
    system = system_for(rays.shape[0])
    state = system.state_for(program_models(weights))
    losses, _, grads = system.loss_and_grads(state, rays, rgbs, None, labels, noise=draws)
    names = [(k, n) for k, n, _ in parameters(state.models)]
    got = {n: g for (k, n), g in zip(names, grads) if k == "points"}
    assert all(float(g.abs().max()) == 0 for (k, _), g in zip(names, grads) if k != "points")

    params = {k: v.clone().requires_grad_(True) for k, v in weights["points"].items()}
    out = ref.render(weights["coarse"], weights["fine"], params, CFG, rays,
                     ref.operand_round("fp32"), draws)
    loss = ref.msenll(out, rgbs, labels)
    loss.backward()
    assert abs(float(losses["sum"].detach()) - float(loss.detach())) <= 1e-6 * float(loss.detach())
    grad = ref.learning({k: p.grad for k, p in params.items()})
    got = ref.learning(got)
    top = max(float(torch.linalg.vector_norm(v)) for v in grad.values())
    for k in grad:
        assert float(torch.linalg.vector_norm(got[k] - grad[k])) <= 2e-3 * top, k

    system.train_step(state, {"rays": rays, "rgbs": rgbs, "cls": labels}, SEED)
    _, _, _, _, after, _ = ref.train_steps({f: weights[f] for f in ("coarse", "fine")},
                                           weights["points"], CFG, [(rays, rgbs, labels)],
                                           SEED, {"lr": LR, "perturb": 1.0, "noise_std": 1.0},
                                           ref.operand_round("fp32"))
    w0 = weights["points"]
    moved = ref.learning({k: v - w0[k] for k, v in state.models["points"].state_dict().items()})
    want = ref.learning({k: v - w0[k] for k, v in after.items()})
    for k in want:
        sure = grad[k].abs() >= 0.05 * grad[k].abs().max()
        assert sure.any(), k
        assert float(torch.linalg.vector_norm((moved[k] - want[k])[sure])) <= \
            1e-3 * float(torch.linalg.vector_norm(want[k][sure])), k


# the d3 cell at a tiny size: 64 rays a step at 8 + 8 samples (1,536 slots a step)
TINY = {"traffic": {"cameras": dict(CAMS, width=16, height=16), "rays_per_step": 64,
                    "point_capacity": 64 * 16, "warmup_steps": 1, "traced_steps": 1},
        "config": {"n_samples": 8, "n_importance": 8}}


@pytest.mark.parametrize("capacity", [64 * 16, 4], ids=["every sample", "below the valid count"])
def test_cell_check_fails_below_the_valid_count(capacity):
    """The whole cloud passes the cell's check; a capacity below the valid
    count (every slot holds a valid point: the top weights alone) moves the
    composited classes past `cls_gap`'s limit, so the run is not correct."""
    overrides = json.loads(json.dumps(TINY))
    overrides["traffic"]["point_capacity"] = capacity
    tracing.reset()
    tracing.enable()
    try:
        run = harness.run_cell("d3_pointnet_blender.train", SEED, 0.0, False, CPU, overrides)
    finally:
        tracing.disable()
    counts = tracing.counters()
    tracing.reset()
    checks = {n: (v, lim) for n, v, lim in run.checks}
    if capacity == 4:
        assert counts["d3.cloud_valid"] == counts["d3.cloud_slots"]
        assert not run.correct and checks["cls_gap"][0] > checks["cls_gap"][1], checks
    else:
        assert counts["d3.cloud_valid"] < counts["d3.cloud_slots"]
        assert run.correct, checks
        # the model flops count the point network at the valid points alone
        points = run.readings["points_per_step"]
        assert 0 < points < 64 * (8 + 16)
        assert run.readings["step_flops"] == bench_nerf3d.step_flops(
            run.config, run.traffic, points)


def test_class_targets_are_a_function_of_the_ray():
    rays = scenes.frame_rays(CAMS, SEED, CPU).reshape(-1, 8).numpy()
    a = bench_nerf3d.class_table(rays, CFG, SEED, CPU, block=50)
    b = bench_nerf3d.class_table(rays, CFG, SEED, CPU)
    assert (a == b).all() and len(set(a.tolist())) > 1
