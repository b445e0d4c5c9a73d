"""The semantic cloud's valid prefix (`render/rendering_3d.py`): the weights
are sorted in descending order, so the valid points are the cloud's first m
slots, and an eager pass runs the point network on those m rows alone. The
masked path (the network on all K slots with the validity mask) is what a
CUDA-graph capture runs; here it is driven through the module's own capture
predicate, `_capturing`, monkeypatched.

Tolerances and why:
- class log-probabilities and gradients, prefix against masked: atol 1e-5
  plus 1e-5 of each tensor's largest magnitude (measured 0 on the CPU at
  these shapes): the same float32 products; the BatchNorm statistics and
  the weight gradients' sums over the rows may be grouped otherwise, since
  the masked path adds its padding's exact zeros;
- with no valid slot, the masked path's point-network gradients are exact
  zeros and the prefix path's none (read as zeros): one Adam step of each
  leaves the parameters and both moments bit-equal.
"""
import copy

import numpy as np
import pytest
import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.models.pointnet import PointNetDenseCls
from nerf_siren_tpu_torch.models.voxel_unet import VoxelUNet
from nerf_siren_tpu_torch.render import rendering_3d
from nerf_siren_tpu_torch.render.rendering_3d import semantic_from_weights
from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem
from nerf_siren_tpu_torch.training.system import parameters
from nerf_siren_tpu_torch.utils import tracing
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

R, S, C = 8, 16, 6


@pytest.fixture
def traced():
    tracing.enable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def cloud(valid: str, seed=0, threshold=0.0):
    """xyz, rgb (R, S, 3) and weights (R, S) whose share of weights above
    `threshold` is `valid` ('some', 'all', 'none'), with ties: a run of
    equal weights, and (at a threshold above 0) weights exactly at it."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(R, S, 3)).astype(np.float32)
    rgb = rng.uniform(size=(R, S, 3)).astype(np.float32)
    n = R * S
    if valid == "all":
        w = rng.uniform(threshold + 0.01, threshold + 0.4, n)
        w[rng.permutation(n)[:20]] = threshold + 0.2              # ties among the valid
    elif valid == "none":
        w = rng.uniform(0.0, threshold, n) if threshold > 0 else np.zeros(n)
        w[rng.permutation(n)[:10]] = threshold                    # at the threshold: invalid
    else:
        w = np.zeros(n)
        on = rng.permutation(n)[:50]
        w[on] = rng.uniform(threshold + 0.01, threshold + 0.4, 50)
        w[on[:12]] = threshold + 0.2                              # a run of ties
        w[on[12:20]] = threshold                                  # at the threshold: invalid
    return (torch.from_numpy(xyz), torch.from_numpy(rgb),
            torch.from_numpy(w.astype(np.float32).reshape(R, S)))


def network(kind):
    g = torch.Generator().manual_seed(3)
    if kind == "pointnet":
        return PointNetDenseCls(C, 6, generator=g)
    return VoxelUNet(7, C, res=8, generator=g)


class Spy(torch.nn.Module):
    """A point network that keeps the rows and mask of each call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def forward(self, pts, mask):
        self.calls.append((pts.shape[0], mask))
        return torch.zeros(pts.shape[0], C)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
@pytest.mark.parametrize("valid", ["some", "all", "none"])
@pytest.mark.parametrize("capacity", [48, 200])
def test_the_valid_mask_is_a_prefix_of_the_sorted_cloud(threshold, valid, capacity,
                                                        monkeypatch):
    """The masked path's mask is a prefix of the K-slot cloud, of as many
    slots as weights exceed the threshold (at most K); the eager path runs
    the network on exactly those rows, with no mask."""
    xyz, rgb, w = cloud(valid, threshold=threshold)
    kw = dict(n_classes=C, threshold=threshold, point_capacity=capacity)
    k = min(capacity, R * S)
    m = min(int((w > threshold).sum()), k)
    spy = Spy()
    with monkeypatch.context() as mp:
        mp.setattr(rendering_3d, "_capturing", lambda t: True)
        semantic_from_weights(spy, xyz, rgb, w, **kw)
    ((rows, mask),) = spy.calls
    assert rows == k
    assert torch.equal(mask, torch.arange(k) < m)
    spy.calls.clear()
    semantic_from_weights(spy, xyz, rgb, w, **kw)
    assert spy.calls == ([(m, None)] if m else [])


def leaf_grads(net, inputs, out, probe):
    """Gradients of (out * probe).sum() to every leaf of `net` (none: zeros)
    and to the inputs."""
    leaves = list(net.parameters()) + list(inputs)
    grads = torch.autograd.grad((out * probe).sum(), leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def close(got, want, name):
    scale = float(want.detach().abs().max())
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                               atol=1e-5 + 1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("kind", ["pointnet", "conv3d"])
@pytest.mark.parametrize("valid", ["some", "all", "none"])
@pytest.mark.parametrize("capacity", [48, 200])
def test_the_prefix_path_equals_the_masked_path(kind, valid, capacity, monkeypatch):
    """cls and the gradients of a probe of it to every leaf of the point
    network and to rgb and the weights, at capacities below and above
    R * S; with no valid slot both give zeros."""
    xyz, rgb, w = cloud(valid, seed=1)
    net = network(kind)
    kw = dict(n_classes=C, threshold=0.0, point_capacity=capacity)
    probe = torch.from_numpy(np.random.default_rng(5).normal(size=(R, C)).astype(np.float32))
    runs = []
    for capture in (True, False):
        rgb_in, w_in = rgb.clone().requires_grad_(), w.clone().requires_grad_()
        with monkeypatch.context() as mp:
            if capture:
                mp.setattr(rendering_3d, "_capturing", lambda t: True)
            out = semantic_from_weights(net, xyz, rgb_in, w_in, **kw)
        runs.append((out, leaf_grads(net, (rgb_in, w_in), out, probe)))
    (want, want_g), (got, got_g) = runs
    names = [n for n, _ in net.named_parameters()] + ["rgb", "weights"]
    close(got, want, "cls")
    for name, a, b in zip(names, got_g, want_g):
        close(a, b, name)
    if valid == "none":
        assert not want.any() and not got.any()
        assert all(not g.any() for g in want_g[:-2] + got_g[:-2])
    else:
        assert want.abs().max() > 0.1
        assert sum(bool(g.any()) for g in got_g) > len(got_g) // 2


def d3_system():
    return NeRF3DSystem(RenderConfig(n_samples=8, n_importance=8, perturb=1.0, noise_std=0.0),
                        TrainConfig(loss_type="msenll", lr=5e-3, batch_size=32),
                        NeRFConfig(depth=2, width=32, skips=()), steps_per_epoch=10,
                        point_capacity=200, device="cpu")


def batch(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(32, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(32, 3)) * 0.2, d, np.full((32, 1), 2.0),
                           np.full((32, 1), 6.0)], -1).astype(np.float32)
    return {"rays": rays, "rgbs": rng.uniform(size=(32, 3)).astype(np.float32),
            "cls": rng.integers(0, C, 32)}


def test_an_empty_cloud_takes_the_masked_paths_adam_step(monkeypatch):
    """After a step with valid points (so Adam's moments are not 0), a step
    whose fields have no density anywhere (no weight above 0: both clouds
    empty) leaves the same parameters and moments, bit for bit, on the
    prefix path (no network run, no gradient) as on the masked path (exact
    zero gradients)."""
    system = d3_system()
    state, _ = system.train_step(system.init_state(0), batch(1), 1)
    for key in ("coarse", "fine"):
        with torch.no_grad():
            state.models[key].sigma.bias.fill_(-1e4)
    runs = []
    for capture in (True, False):
        s = system.state_for(copy.deepcopy(state.models))
        s.opt_state = copy.deepcopy(state.opt_state)
        s.step = state.step
        with monkeypatch.context() as mp:
            if capture:
                mp.setattr(rendering_3d, "_capturing", lambda t: True)
            tracing.enable()
            try:
                s, metrics = system.train_step(s, batch(2), 1)
                counts = tracing.counters()
            finally:
                tracing.disable()
                tracing.reset()
        assert counts["d3.cloud_valid"] == 0
        runs.append((s, float(metrics[system.LOSS_KEY])))
    (want, want_loss), (got, got_loss) = runs
    assert got_loss == want_loss
    for (_, name, a), (_, _, b) in zip(parameters(got.models), parameters(want.models)):
        assert torch.equal(a, b), name
    assert got.opt_state["count"] == want.opt_state["count"]
    for key in ("mu", "nu"):
        assert len(got.opt_state[key]) == len(want.opt_state[key])
        for a, b in zip(got.opt_state[key], want.opt_state[key]):
            assert torch.equal(a, b), key
    mu = [m for (k, _, _), m in zip(parameters(got.models), got.opt_state["mu"])
          if k == "points"]
    assert sum(bool(m.any()) for m in mu) > len(mu) // 2   # the first step's moments decay


@pytest.mark.parametrize("capture", [False, True], ids=["eager", "masked"])
def test_points_rows_counts_the_prefix_eager_and_every_slot_masked(capture, traced,
                                                                   monkeypatch):
    """`d3.points_rows`: the valid points of each pass eager (the device
    counter `d3.cloud_valid`), its K slots on the masked path
    (`d3.cloud_slots`); per call, m or K."""
    if capture:
        monkeypatch.setattr(rendering_3d, "_capturing", lambda t: True)
    system = d3_system()
    system.train_step(system.init_state(0), batch(3), 1)
    counts = tracing.counters()
    assert counts["d3.cloud_slots"] == 2 * 200
    assert 0 < counts["d3.cloud_valid"] < counts["d3.cloud_slots"]
    want = counts["d3.cloud_slots" if capture else "d3.cloud_valid"]
    assert counts["d3.points_rows"] == want
    tracing.reset()
    xyz, rgb, w = cloud("some")
    semantic_from_weights(Spy(), xyz, rgb, w, n_classes=C, threshold=0.0, point_capacity=48)
    assert tracing.counters()["d3.points_rows"] == (48 if capture else int((w > 0).sum()))
