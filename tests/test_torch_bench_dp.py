"""The benchmark's data-parallel driver (`benchmark/drivers/train_dp.py`)
on the CPU: the cell `nerf_blender.train_dp4` at a tiny size spawns its
three ranks beside the test's process (rank 0), four gloo ranks train the
one-process trajectory of the global batch (the check against the
reference passes, every rank's weights equal rank 0's), and the rate
counts every rank's rays. With the step's all-reduce left out on every
rank, each rank trains on its own rows alone, and the check fails."""
import contextlib

import pytest
import torch

from benchmark import harness
from benchmark.drivers import train_dp
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

_spawned_rank = train_dp._rank_main

CAMERAS = {"count": 2, "width": 16, "height": 16, "camera_angle_x": 0.69, "radius": 4.0,
           "elevation_deg": [5, 85], "near": 2.0, "far": 6.0}
TINY = {"traffic": {"cameras": CAMERAS, "rays_per_step": 16, "steps_per_dispatch": 2,
                    "warmup_groups": 1, "timing_groups": 1, "traced_groups": 1,
                    "reference_block": 64},
        "config": {"n_samples": 8, "n_importance": 8}}


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def test_four_gloo_ranks_and_the_rate(threads):
    run = harness.run_cell("nerf_blender.train_dp4", 2 ** 31 + 404, 0.1, False,
                           torch.device("cpu"), TINY)
    checks = {n: v for n, v, _ in run.checks}
    assert run.correct, run.checks
    assert checks["rank_weight_gap"] == 0.0
    r = run.readings
    assert r["steps"] == run.attempted > 0 and r["steps"] % 2 == 0 and run.failed == 0
    assert run.e2e["train_rays_per_s"] == pytest.approx(r["steps"] * 16 * 4 / r["window_s"])


@contextlib.contextmanager
def no_all_reduce():
    """Every step of this process takes its own rank's losses and gradients
    as they are: the all-reduce of `DataParallel.reduce_step` left out."""
    from nerf_siren_tpu_torch.parallel.shard_train import DataParallel
    from nerf_siren_tpu_torch.training.metrics import psnr

    def local_step(self, losses, pred, target, grads):
        return losses, psnr(pred.detach(), target), list(grads)

    inner = DataParallel.reduce_step
    DataParallel.reduce_step = local_step
    try:
        yield
    finally:
        DataParallel.reduce_step = inner


def _rank_without_all_reduce(i, *args):
    """A spawned rank of the driver whose steps leave the all-reduce out."""
    with no_all_reduce():
        _spawned_rank(i, *args)


def test_the_check_fails_when_the_ranks_leave_the_all_reduce_out(threads, monkeypatch):
    monkeypatch.setattr(train_dp, "_rank_main", _rank_without_all_reduce)
    with no_all_reduce():
        run = harness.run_cell("nerf_blender.train_dp4", 2 ** 31 + 405, 0.1, False,
                               torch.device("cpu"), TINY)
    failed = {n for n, v, limit in run.checks if not v <= limit}
    assert not run.correct
    assert {"rank_weight_gap", "loss_gap.1", "loss_gap", "moment_gap",
            "change_gap"} <= failed, run.checks
