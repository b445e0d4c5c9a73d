"""The correctness check at tiny sizes on the CPU (the port's kernels run
their plain versions here): a sound run comes out correct; the control (the
reference at the precision below the configuration's, in the program's
place) and each fault a cell can have, planted under the timed path, come
out not correct."""
import pytest
import torch

from benchmark import faults, harness

CPU = torch.device("cpu")
FAULTS = {"nerf_blender.train": ("frozen_state", "half_batch", "stale_batch", "stale_draws"),
          # EG3D's draws move a step's loss less than its own drift from the
          # reference after one step: its check compares one step at a time
          "eg3d_blender.train": ("frozen_state", "half_batch", "stale_batch"),
          "nerf_blender.render_exact": ("altered_answer",),
          # `frozen_distill` is read on the card at the cell's size (calibrate.py): at
          # these sizes an untrained proxy still places its samples on the ball
          "nerf_blender.render_fast": ("altered_answer",)}
SEED = 2 ** 31 + 101


def cells():
    return [w["name"] for w in harness.manifest()["workloads"] if w["name"] in FAULTS]


@pytest.mark.parametrize("cell", cells())
def test_sound_run_is_correct(cell, tiny):
    run = harness.run_cell(cell, SEED, 0.2, False, CPU, tiny[cell])
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell, tiny):
    workload, config = harness.load_cell(cell)
    workload["traffic"].update(tiny[cell]["traffic"])
    config.update(tiny[cell]["config"])
    run = harness.Run(workload, config, SEED, 0.0, False, CPU, 0.0)
    readings = harness.driver_module(workload["driver"]).control(run)
    limits = workload["limits"]
    assert any(readings[k] > limits[k] for k in limits), readings


@pytest.mark.parametrize("cell,fault", [(c, f) for c in cells() for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault, tiny):
    with faults.FAULTS[fault]():
        run = harness.run_cell(cell, SEED, 0.2, False, CPU, tiny[cell])
    assert not run.correct, run.checks
