"""The port's semantic stack against the JAX package's, on the CPU: PointNet
and the voxel UNet (`models/pointnet.py`, `models/voxel_unet.py`, weights
through `convert.points_from_jax`), `semantic_from_weights` and
`render_rays_3d` (`render/rendering_3d.py`), one `NeRF3DSystem` step for
each point network, the grouped steps with class targets, the semantic
loaders, the class-map metrics and `color_cls`.

Tolerances and why:
- PointNet log-probabilities (masks: none, all valid, partial): atol 1e-4,
  the same float32 products and masked BN statistics summed in another
  order (measured 6e-6). With no valid point the BN variance is 0 and
  each BN multiplies by 1/sqrt(eps) (~316), so the logits reach ~1e8:
  there the bar is relative, 2e-4 of max(1, |ref|) (measured 4e-5).
- the voxel grid, the UNet and its point logits: atol 1e-5 (measured
  2e-7); the voxel indices exactly.
- `semantic_from_weights`: atol 1e-5 (measured 6e-6), with ties planted
  at the capacity cut: a different tie break moves the cloud, and with it
  every output by ~1e-2.
- `render_rays_3d` (a narrow field with density on every ray, perturb 0):
  rgb, depth, opacity atol 1e-5 and rtol 1e-5 (depths of ~4), cls atol
  1e-4. XLA fuses the sample
  positions' multiply-add (tests/test_torch_training.py), which moves the
  weights by ~1e-7 and the log-probabilities by up to ~1e-5.
- one `NeRF3DSystem` step: loss rtol 1e-5; each of the point network's
  gradients within 1e-2 of its norm (measured 4e-3, in STN, which the
  sample positions' last bit reaches through its max-pool) plus 1e-5 of
  the largest gradient's norm (the tensors that feed only PointNet's
  global feature, which every point's BN mean cancels, and the biases
  ahead of a BN, have gradients of round-off, ~1e-8, on both sides); the
  parameters after the step within
  atol 1e-6 of optax's Adam on the port's own gradients (as
  tests/test_torch_training.py holds the NeRF step); the frozen NeRF
  bit-unchanged, as JAX's zero gradients leave it.
- the grouped steps (the captured graph's CPU loop) against `train_step`s,
  the loaders, the metrics and `color_cls`: exact (rays atol 1e-6: JAX
  builds LLFF rays with its C++ helper, tests/test_torch_llff.py).
"""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.config import TrainConfig as JTrainConfig
from nerf_siren_tpu.models import pointnet as jpointnet
from nerf_siren_tpu.models import voxel_unet as jvoxel
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.render import rendering_3d as jr3d
from nerf_siren_tpu.training import metrics as jmetrics
from nerf_siren_tpu.training.semantic_system import NeRF3DSystem as JNeRF3DSystem
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import nerf_from_jax, points_from_jax, points_to_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.models.pointnet import (PointNetDenseCls,
                                                  feature_transform_regularizer)
from nerf_siren_tpu_torch.models.voxel_unet import VoxelUNet, same_padding, voxelize_points
from nerf_siren_tpu_torch.render.rendering_3d import render_rays_3d, semantic_from_weights
from nerf_siren_tpu_torch.training import metrics
from nerf_siren_tpu_torch.training.semantic_system import NeRF3DSystem
from nerf_siren_tpu_torch.training.system import epoch_iterator, parameters
from tests.test_torch_rendering import with_density

NARROW = dict(depth=2, width=32, skips=())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while this module runs. The tier-1 run
    puts 6 pytest workers on 8 cores, where torch's OpenMP pool spins
    against the other workers' threads: a d3 CLI run took 197 s with the
    default pool and 16 s with one thread beside 6 busy processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def numpy_tree(init, *args, seed=0):
    """A tree with `init(key, *args)`'s structure and shapes
    (`jax.eval_shape`, nothing compiled: JAX's random init compiles for
    seconds on the CPU) drawn from numpy: kernels U(+-1/sqrt(fan-in)), BN
    scales 1 + U(+-0.1), every other leaf U(+-0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            b = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            b = 0.1
        a = rng.uniform(-b, b, leaf.shape) + (1.0 if name == "scale" else 0.0)
        return a.astype(np.float32)

    shapes = jax.eval_shape(lambda key: init(key, *args), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pointnet(k=6, seed=1):
    params = numpy_tree(jpointnet.init_pointnet_dense_cls, k, 6, seed=seed)
    net = PointNetDenseCls(k, 6)
    net.load_state_dict(points_from_jax(params))
    return params, net


def _unet(res, seed=2):
    params = numpy_tree(jvoxel.init_voxel_unet, 7, 6, seed=seed)
    net = VoxelUNet(7, 6, res=res)
    net.load_state_dict(points_from_jax(params))
    return params, net


def _cloud(p=200, seed=0):
    """(P, 6) [xyz, rgb] with an odd extent on each axis."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (p, 3)) * np.array([1.3, 0.7, 2.9]) + np.array([0.2, -1.0, 0.5])
    return np.concatenate([xyz, rng.uniform(size=(p, 3))], -1).astype(np.float32)


# ---- the point networks --------------------------------------------------------

@pytest.mark.parametrize("mask", ["none", "full", "partial", "empty"])
def test_pointnet_matches_jax(mask):
    params, net = _pointnet()
    pts = _cloud()
    m = {"none": None, "full": np.ones(200, bool), "partial": np.arange(200) % 3 != 0,
         "empty": np.zeros(200, bool)}[mask]
    want = np.asarray(jax.jit(jpointnet.apply_pointnet_dense_cls)(
        params, pts, None if m is None else jnp.asarray(m)))
    with torch.no_grad():
        got = net(torch.from_numpy(pts), None if m is None else torch.from_numpy(m)).numpy()
    if mask == "empty":
        np.testing.assert_array_less(np.abs(got - want) / np.maximum(1, np.abs(want)), 2e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    tree = points_to_jax(net.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    trans = np.random.default_rng(3).normal(size=(4, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(float(feature_transform_regularizer(torch.from_numpy(trans))),
                               float(jpointnet.feature_transform_regularizer(trans)),
                               rtol=1e-6)


def test_voxelize_and_unet_match_jax():
    """res 8 and res 5: the stride-2 convolutions' XLA "SAME" padding (0
    before and 1 after on an even axis, 1 and 1 on an odd one) and the
    cropped upsample; the grid over the valid points' odd-extent box."""
    assert same_padding((32, 32, 32), 3, 2) == (0, 1) * 3
    assert same_padding((5, 3, 2), 3, 2) == (0, 1, 1, 1, 1, 1)
    pts = _cloud()
    valid = np.arange(200) < 150
    feats = np.concatenate([pts, valid[:, None]], -1).astype(np.float32)
    grid_j, flat_j = jvoxel.voxelize_points(pts[:, :3], feats, jnp.asarray(valid), 8)
    grid, flat = voxelize_points(torch.from_numpy(pts[:, :3]), torch.from_numpy(feats),
                                 torch.from_numpy(valid), 8)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_j), rtol=0, atol=1e-5)
    for res in (8, 5):
        params, net = _unet(res)
        g = np.random.default_rng(res).normal(size=(1, res, res, res, 7)).astype(np.float32)
        want = np.asarray(jax.jit(jvoxel.apply_voxel_unet)(params, g))
        with torch.no_grad():
            got = net.grid_forward(torch.from_numpy(g).permute(0, 4, 1, 2, 3))
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, rtol=0,
                                   atol=1e-5)
        for m in (None, valid):
            want = np.asarray(jax.jit(jvoxel.apply_voxel_unet_points, static_argnames="res")(
                params, pts, None if m is None else jnp.asarray(m), res=res))
            with torch.no_grad():
                got = net(torch.from_numpy(pts), None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# ---- semantic_from_weights and render_rays_3d ------------------------------------

@pytest.mark.parametrize("capacity", [30, 64, 128])
@pytest.mark.parametrize("norm", ["frob", "rms"])
def test_semantic_from_weights_matches_jax(capacity, norm):
    """40 valid samples of 128, the last 15 of them tied across a
    capacity-30 cut (the sort's stable order decides which 5 enter, as JAX's
    argsort's); capacity 64 and 128 hold every valid sample."""
    params, net = _pointnet()
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(8, 16, 3)).astype(np.float32)
    rgb = rng.uniform(size=(8, 16, 3)).astype(np.float32)
    w = np.zeros(128, np.float32)
    w[rng.permutation(128)[:40]] = rng.uniform(0.05, 1.0, 40)
    order = np.argsort(-w, kind="stable")
    w[order[25:40]] = 0.03                                  # ties straddling the cut at 30
    w = w.reshape(8, 16)
    kw = dict(n_classes=6, threshold=0.0, point_capacity=capacity, point_norm=norm)
    want = np.asarray(jax.jit(lambda p, *a: jr3d.semantic_from_weights(p, *a, **kw))(
        params, xyz, rgb, w))
    with torch.no_grad():
        got = semantic_from_weights(net, torch.from_numpy(xyz), torch.from_numpy(rgb),
                                    torch.from_numpy(w), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if capacity == 30:   # a reversed tie order takes another cloud: the test sees it
        flipped = w.reshape(-1).copy()
        ties = np.flatnonzero(flipped == np.float32(0.03))
        flipped[ties[-1]] = np.float32(0.03) + 1e-6
        with torch.no_grad():
            other = semantic_from_weights(net, torch.from_numpy(xyz), torch.from_numpy(rgb),
                                          torch.from_numpy(flipped.reshape(8, 16)), **kw)
        assert np.abs(other.numpy() - want).max() > 1e-4


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.2, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)


def _models(jparams, nerf_cfg):
    models = {}
    for k, p in jparams.items():
        if k == "points":
            models[k] = _pointnet()[1]
            models[k].load_state_dict(points_from_jax(p))
        else:
            models[k] = NeRF(nerf_cfg)
            models[k].load_state_dict(nerf_from_jax(p))
    return models


@pytest.mark.parametrize("n_importance", [0, 8])
def test_render_rays_3d_matches_jax(n_importance):
    jparams = {"coarse": with_density(numpy_tree(init_nerf, JNeRFConfig(**NARROW), seed=3)),
               "points": _pointnet()[0]}
    if n_importance:
        jparams["fine"] = with_density(numpy_tree(init_nerf, JNeRFConfig(**NARROW), seed=4))
    rays = _rays(12)
    kw = dict(n_samples=16, n_importance=n_importance, perturb=0.0, noise_std=0.0)
    want = jax.jit(lambda p, r: jr3d.render_rays_3d(
        p, r, JRenderConfig(**kw), None, nerf_cfg=JNeRFConfig(**NARROW),
        point_capacity=100))(jparams, jnp.asarray(rays))
    models = _models(jparams, NeRFConfig(**NARROW))
    got = render_rays_3d(models, torch.from_numpy(rays), RenderConfig(**kw), None,
                         point_capacity=100)
    assert set(got) == set(want)
    for k, v in want.items():
        tol = dict(rtol=0, atol=1e-4) if k.startswith("cls") else dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), err_msg=k, **tol)
    # no_grad_on_nerf: only the point network is differentiated
    sum(v.sum() for k, v in got.items() if k.startswith("cls")).backward()
    assert all(p.grad is None for k in models if k != "points"
               for p in models[k].parameters())
    assert all(p.grad is not None for p in models["points"].parameters())


# ---- the d3 system ---------------------------------------------------------------

def _cls_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"rays": _rays(n, seed), "rgbs": rng.uniform(size=(n, 3)).astype(np.float32),
            "cls": rng.integers(0, 6, n).astype(np.int32)}


@pytest.mark.parametrize("network", ["pointnet", "conv3d"])
def test_nerf3d_step_matches_jax_and_freezes_the_nerf(network):
    rkw = dict(n_samples=8, n_importance=8, perturb=0.0, noise_std=0.0)
    tkw = dict(lr=1e-3, loss_type="msenll", decay_step=(100,))
    jsys = JNeRF3DSystem(JRenderConfig(**rkw), JTrainConfig(**tkw), JNeRFConfig(**NARROW),
                         steps_per_epoch=4, semantic_network=network, point_capacity=512)
    jparams = {k: (v if k == "points" else with_density(v)) for k, v in
               numpy_tree(jsys.init_params).items()}
    batch = _cls_batch()
    key = jax.random.PRNGKey(1)

    def jloss(p):
        out = jr3d.render_rays_3d(p, jnp.asarray(batch["rays"]), jsys.render_cfg.replace(
            test_time=False), key, nerf_cfg=jsys.nerf_cfg, point_capacity=512,
            points_apply=jsys._points_apply)
        losses = jsys.loss_fn(out, jnp.asarray(batch["rgbs"]),
                              cls_target=jnp.asarray(batch["cls"]))
        return losses["sum"], (losses, out["rgb_fine"])

    (ref_loss, (ref_losses, ref_rgb)), ref_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jparams)
    jm = {"train/total_loss": ref_loss, "train/rgb_loss": ref_losses["rgb"],
          "train/cls_loss": ref_losses["cls"],
          "train/psnr": jmetrics.psnr(ref_rgb, jnp.asarray(batch["rgbs"]))}

    system = NeRF3DSystem(RenderConfig(**rkw), TrainConfig(**tkw), NeRFConfig(**NARROW),
                          steps_per_epoch=4, semantic_network=network, point_capacity=512,
                          device="cpu")
    models = {k: NeRF(NeRFConfig(**NARROW)) for k in ("coarse", "fine")}
    models["points"] = system.init_state(0).models["points"]
    for k, m in models.items():
        m.load_state_dict((points_from_jax if k == "points" else nerf_from_jax)(jparams[k]))
    state = system.state_for(models)
    start = [p.detach().clone() for _, _, p in parameters(state.models)]
    rays, rgbs = torch.from_numpy(batch["rays"]), torch.from_numpy(batch["rgbs"])
    losses, _, grads = system.loss_and_grads(state, rays, rgbs, None,
                                             cls_target=torch.from_numpy(batch["cls"]))
    np.testing.assert_allclose(float(losses["sum"].detach()), float(ref_loss), rtol=1e-5)
    names = [(k, n) for k, n, _ in parameters(state.models)]
    want = {k: (points_from_jax if k == "points" else nerf_from_jax)(_np(v))
            for k, v in ref_grads.items()}
    scale = max(float(want[k][n].norm()) for k, n in names if k == "points")
    for (k, n), g in zip(names, grads):
        if k != "points":
            assert not g.any() and not want[k][n].any(), (k, n)
            continue
        err, ref = float((g - want[k][n]).norm()), float(want[k][n].norm())
        assert err <= 1e-2 * ref + 1e-5 * scale, f"{k} {n}: |d| {err:.2e}, |ref| {ref:.2e}"

    state, m = system.train_step(state, batch, seed=1)
    for name in ("train/total_loss", "train/rgb_loss", "train/cls_loss", "train/psnr"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    port = {k: points_to_jax({n: g for (kk, n), g in zip(names, grads) if kk == k})
            for k in ("points",)}
    updates, _ = jsys.tx.update(port, jsys.tx.init({"points": jparams["points"]}),
                                {"points": jparams["points"]})
    want_points = points_from_jax(_np(optax.apply_updates({"points": jparams["points"]},
                                                          updates))["points"])
    for n, p in state.models["points"].state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_points[n].numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)
    now = [p.detach() for _, _, p in parameters(state.models)]
    same = [torch.equal(a, b) for a, b in zip(start, now)]
    assert all(s for (k, _), s in zip(names, same) if k != "points")
    moved = [not s for (k, _), s in zip(names, same) if k == "points"]
    assert sum(moved) >= len(moved) // 2, moved


def test_nerf3d_grouped_steps_equal_train_steps():
    """`train_scan_batches(..., cls_b)` (the captured graph's CPU loop) takes
    the same steps as `train_step`s on the same batches and seed, bit for
    bit; JAX's pool scans take no class targets, so the port refuses them."""
    rkw = dict(n_samples=8, n_importance=8, perturb=1.0, noise_std=1.0)
    system = NeRF3DSystem(RenderConfig(**rkw), TrainConfig(lr=1e-3, loss_type="msenll"),
                          NeRFConfig(**NARROW), steps_per_epoch=4, point_capacity=256,
                          device="cpu")
    eager = system.init_state(2)
    grouped = system.state_for(copy.deepcopy(eager.models))
    batches = [_cls_batch(32, seed) for seed in range(3)]
    for b in batches:
        eager, m = system.train_step(eager, b, seed=5)
    grouped, mg = system.train_scan_batches(
        grouped, np.stack([b["rays"] for b in batches]), np.stack([b["rgbs"] for b in batches]),
        seed=5, cls_b=np.stack([b["cls"] for b in batches]))
    assert float(mg["train/total_loss"]) == float(m["train/total_loss"])
    assert system.last_group.steps.shape == (3, 2)
    for (_, n, a), (_, _, b) in zip(parameters(eager.models), parameters(grouped.models)):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="class targets"):
        system.train_scan_batches(grouped, batches[0]["rays"][None], batches[0]["rgbs"][None], 5)
    for scan in (system.train_scan, system.train_scan_importance):
        with pytest.raises(NotImplementedError, match="class targets"):
            scan(grouped, batches[0]["rays"], batches[0]["rgbs"], 5, 2)


def test_epoch_iterator_batches_extras_as_jax():
    from nerf_siren_tpu.training.system import epoch_iterator as j_epoch_iterator

    rng = np.random.default_rng(3)
    rays = rng.normal(size=(300, 8)).astype(np.float32)
    rgbs = rng.uniform(size=(300, 3)).astype(np.float32)
    extras = {"cls": rng.integers(0, 6, 300).astype(np.int32)}
    ref = list(j_epoch_iterator(rays, rgbs, 64, seed=5, epoch=1, extras=extras))
    got = list(epoch_iterator(rays, rgbs, 64, seed=5, epoch=1, extras=extras))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert set(a) == set(b) == {"rays", "rgbs", "cls"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---- loaders, metrics, colours ----------------------------------------------------

@pytest.fixture(scope="module")
def cls_scenes(tmp_path_factory):
    from tests.datasets_synthetic import (make_blender_cls_dataset, make_llff_cls_dataset,
                                          make_replica_dataset)

    return {"blender_cls_ib": make_blender_cls_dataset(str(tmp_path_factory.mktemp("b")),
                                                       n_train=2, hw=16),
            "llff_cls": make_llff_cls_dataset(str(tmp_path_factory.mktemp("l")), hw=(20, 15)),
            "replica": make_replica_dataset(str(tmp_path_factory.mktemp("r")), n_frames=6,
                                            hw=(20, 15))}


@pytest.mark.parametrize("name,split", [("blender_cls_ib", "train"), ("blender_cls_ib", "val"),
                                        ("llff_cls", "train"), ("llff_cls", "val"),
                                        ("llff_cls_ib", "train"), ("replica", "train"),
                                        ("replica", "test")])
def test_semantic_loaders_match_jax(cls_scenes, name, split):
    from nerf_siren_tpu.datasets import dataset_dict as jax_datasets
    from nerf_siren_tpu_torch.datasets import dataset_dict

    root = cls_scenes[name.replace("_ib", "") if name.startswith("llff") else name]
    wh = (16, 16) if name.startswith("blender") else (20, 15)
    ref = jax_datasets[name](root_dir=root, split=split, img_wh=wh)
    got = dataset_dict[name](root_dir=root, split=split, img_wh=wh)
    assert type(got).__name__ == type(ref).__name__ and got.n_classes == ref.n_classes
    assert len(got) == len(ref)
    if split == "train":
        np.testing.assert_allclose(got.all_rays, ref.all_rays, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.all_rgbs, ref.all_rgbs)
        np.testing.assert_array_equal(got.all_cls, ref.all_cls)
        assert got.all_cls.max() > 0
    for i in range(min(len(ref), 2)):
        a, b = got[i], ref[i]
        assert set(a) == set(b), (set(a), set(b))
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
    if name == "blender_cls_ib" and split == "train":
        for a, b in zip(got.image_batches(1, seed=2), ref.image_batches(1, seed=2)):
            np.testing.assert_array_equal(a["cls"], b["cls"])


@pytest.mark.parametrize("ignore", [None, 2])
def test_class_metrics_match_jax(ignore):
    rng = np.random.default_rng(5)
    pred = rng.integers(0, 5, 500)
    gt = rng.integers(0, 5, 500)
    gt[gt == 4] = 3                           # class 4 only predicted, never labelled
    pred[pred == 1] = 0
    gt[gt == 1] = 0                           # class 1 absent from both: IoU nan
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    np.testing.assert_array_equal(metrics.confusion_matrix(tp, tg, 5, ignore).numpy(),
                                  np.asarray(jmetrics.confusion_matrix(jp, jg, 5, ignore)))
    for fn, jfn in ((metrics.miou, jmetrics.miou),
                    (metrics.class_accuracy, jmetrics.class_accuracy)):
        got, want = fn(tp, tg, 5, ignore), jfn(jp, jg, 5, ignore)
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


def test_color_cls_writes_jax_pixels(tmp_path):
    """The numpy `color_cls` writes the three PNGs of JAX's cv2 version
    pixel for pixel (classes beyond the palette cycle) and returns its
    overlay."""
    import imageio.v2 as imageio

    from nerf_siren_tpu.utils import color as jcolor
    from nerf_siren_tpu_torch.utils import color

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    pred = rng.integers(-1, 30, (9, 11))
    want = jcolor.color_cls(img, pred, str(tmp_path / "jax"), prefix="0")
    got = color.color_cls(img, pred, str(tmp_path / "port"), prefix="0")
    np.testing.assert_array_equal(got, want)
    for name in ("0pred_map.png", "0img_color.png", "0img_raw.png"):
        np.testing.assert_array_equal(imageio.imread(tmp_path / "port" / name),
                                      imageio.imread(tmp_path / "jax" / name), err_msg=name)
    np.testing.assert_array_equal(color.colorize_cls(pred), jcolor.colorize_cls(pred))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
