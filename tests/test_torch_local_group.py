"""Joining and leaving a group of local ranks
(`parallel/multihost.py::local_group`, which `train.py --num_chips N` and
the benchmark's data-parallel driver both use), on one gloo rank: the
group frees the CUDA graphs of every training system built on its shard
(a graph that captured the all-reduce holds the communicator, which
`destroy_process_group` waits on) and is destroyed, on the normal path and
while an error propagates; a rank of `train.py` leaves its group both
ways."""
import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nerf_siren_tpu_torch import train as train_module
from nerf_siren_tpu_torch.opt import get_opts
from nerf_siren_tpu_torch.parallel.multihost import local_group
from nerf_siren_tpu_torch.training.system import GroupedSteps
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")


class FakeGraph:
    """Stands in for a captured `torch.cuda.CUDAGraph` (the CPU captures none)."""
    resets = 0

    def reset(self):
        self.resets += 1


def _rays(n: int, b: int) -> np.ndarray:
    g = np.random.default_rng(0)
    d = g.normal(size=(n, b, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near_far = np.broadcast_to([2.0, 6.0], (n, b, 2))
    return np.concatenate([-4.0 * d, d, near_far], -1).astype(np.float32)


@pytest.mark.parametrize("fail", [False, True], ids=["normal", "error"])
def test_local_group_frees_the_graphs_before_it_leaves(tmp_path, fail):
    graph = FakeGraph()
    held = []
    raised = pytest.raises(RuntimeError, match="a failed step") if fail \
        else contextlib.nullcontext()
    with raised:
        with local_group(CPU, str(tmp_path / "store"), 1, 0, threads=1) as dp:
            hp = get_opts(["--root_dir", ".", "--N_samples", "4", "--N_importance", "4",
                           "--batch_size", "8", "--device", "cpu"])
            system = train_module.build_system(hp, True, 1, CPU, data_parallel=dp)
            state = system.init_state(0)
            system.train_scan_batches(state, _rays(2, 8), np.zeros((2, 8, 3), np.float32), 0)
            system.last_group.graph = graph
            held.append(system.last_group)   # as an error's traceback keeps a group alive
            if fail:
                raise RuntimeError("a failed step")
    assert graph.resets == 1 and held[0].graph is None
    assert not system._groups and system.last_group is None
    assert not dist.is_initialized()


@pytest.mark.parametrize("fail", [False, True], ids=["normal", "error"])
def test_a_train_rank_releases_its_graphs_and_leaves_its_group(tmp_path, monkeypatch, fail):
    released = []
    inner = GroupedSteps.release_groups

    def release_groups(self):
        released.append(self)
        inner(self)

    monkeypatch.setattr(GroupedSteps, "release_groups", release_groups)
    if fail:   # after the epoch's grouped steps
        def validate(*args, **kwargs):
            raise RuntimeError("validation failed")
        monkeypatch.setattr(train_module, "validate", validate)
    root = make_blender_dataset(str(tmp_path / "scene"), n_train=1, n_val=1, hw=8)
    monkeypatch.chdir(tmp_path)
    hp = get_opts(["--root_dir", root, "--img_wh", "8", "8", "--N_samples", "4",
                   "--N_importance", "4", "--batch_size", "16", "--steps_per_dispatch", "2",
                   "--num_epochs", "1", "--device", "cpu"])
    raised = pytest.raises(RuntimeError, match="validation failed") if fail \
        else contextlib.nullcontext()
    with raised:
        train_module._rank_main(0, hp, ["cpu"], str(tmp_path / "store"), 1)
    assert len(released) == 1 and not released[0]._groups
    assert not dist.is_initialized()
