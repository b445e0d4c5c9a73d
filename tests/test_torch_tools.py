"""The port's tools against the JAX package's, on the same numpy-seeded inputs:
`utils/save_weights_only`, `tools/import_torch_ckpt`, the analytic scene
and the torch oracle (`tools/scene.py`, `tools/oracle.py`),
`tools/psnr_parity` at a toy size, and `vis_log`'s reader.

Tolerances and why:
- save_weights_only, import_torch_ckpt: the written trees are equal to the
  JAX tools' trees, every array bit-equal (the same numpy conversions and
  the same msgpack encoding).
- fields loaded from the port's import render what JAX's `render_rays`
  renders on JAX's import within the bar of
  `tests/test_import_torch_ckpt.py::test_roundtrip_render_matches_torch`:
  more than 95% of the outputs within rtol 1e-3 + atol 1e-4 (float32 on
  both sides; XLA fuses and reorders the field's sums).
- the scene and the oracle: bit-equal to `tools/fast_frontier.py` and
  `tests/test_torch_parity.py::torch_render` (the same code on the CPU).
- psnr_parity at `--steps 3 --train_hw 8 --hw 8 --poses 1` and 32 rays a
  step (full 8x256 width): the JSON has every key of JAX's rows, every
  value finite; K1's wrappers run their plain version on the CPU.
- vis_log: `read_metric` equals what JAX's `vis_log.main` plots, exactly.
"""
import json
import math
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.config import RenderConfig as JRenderConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.render.rendering import render_rays as j_render_rays
from nerf_siren_tpu.training.checkpoints import load_ckpt as j_load_ckpt
from nerf_siren_tpu.utils.save_weights_only import save_weights_only as j_save_weights_only
from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
from nerf_siren_tpu_torch.convert import nerf_to_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp
from nerf_siren_tpu_torch.render.rendering import render_rays
from nerf_siren_tpu_torch.tools import oracle, psnr_parity, scene
from nerf_siren_tpu_torch.tools.import_torch_ckpt import import_torch_ckpt
from nerf_siren_tpu_torch.training.checkpoints import load_checkpoint, load_ckpt, save_train_state
from nerf_siren_tpu_torch.training.system import NeRFSystem
from nerf_siren_tpu_torch.utils.save_weights_only import save_weights_only
from nerf_siren_tpu_torch.vis_log import read_metric
from tests.test_import_torch_ckpt import _torch_nerf_module
from tests import test_torch_parity as jax_parity_test
from tests.test_torch_semantic import numpy_tree, one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import fast_frontier  # noqa: E402
from tools.import_torch_ckpt import import_torch_ckpt as j_import_torch_ckpt  # noqa: E402

NARROW = dict(depth=8, width=32, skips=(4,))


def _lists(tree):
    """A restored tree with int-keyed dicts ({"0": ..}) read as lists."""
    if isinstance(tree, dict):
        if tree and all(str(k).isdigit() for k in tree):
            return [_lists(tree[k]) for k in sorted(tree, key=int)]
        return {k: _lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lists(v) for v in tree]
    return tree


def _assert_trees_equal(got, want, where="root"):
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{where}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert got == want, where


# -- save_weights_only ---------------------------------------------------------------

def test_save_weights_only_equals_jax_tool(tmp_path):
    """A full-resume checkpoint the port wrote (`save_train_state`, Adam
    slots, step, epoch): both tools write the same `params` tree, every
    array bit-equal, and JAX's `load_ckpt` reads the port's file."""
    system = NeRFSystem(RenderConfig(n_samples=4, n_importance=4), TrainConfig(),
                        NeRFConfig(**NARROW), steps_per_epoch=10, device="cpu")
    state = system.init_state(3)
    full = str(tmp_path / "full.msgpack")
    save_train_state(full, state, epoch=2, optimizer="adam")

    ours = save_weights_only(full)
    assert ours == str(tmp_path / "full_weights.msgpack")
    theirs = j_save_weights_only(full, str(tmp_path / "jax_weights.msgpack"))
    got, want = _lists(load_checkpoint(ours)), _lists(load_checkpoint(theirs))
    assert set(got) == {"nerf_coarse", "nerf_fine"}
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, _lists(load_checkpoint(full)["params"]))

    jcfg = JNeRFConfig(**NARROW)
    for key, name in (("coarse", "nerf_coarse"), ("fine", "nerf_fine")):
        loaded = j_load_ckpt(numpy_tree(init_nerf, jcfg, seed=9), ours, name)
        _assert_trees_equal(_lists(jax.tree_util.tree_map(np.asarray, loaded)),
                            nerf_to_jax(state.models[key].state_dict()))


# -- import_torch_ckpt ---------------------------------------------------------------

def _reference_ckpt(path, n_classes=0):
    state = {}
    for seed, name in enumerate(("nerf_coarse", "nerf_fine")):
        for k, v in _torch_nerf_module(seed, n_classes).state_dict().items():
            state[f"{name}.{k}"] = v
    torch.save({"state_dict": state, "epoch": 15}, path)
    return path


@pytest.mark.parametrize("n_classes", [0, 6])
def test_import_tree_equals_jax_tool(tmp_path, n_classes):
    ref = _reference_ckpt(str(tmp_path / "ref.ckpt"), n_classes)
    ours = import_torch_ckpt(ref, str(tmp_path / "ours.msgpack"))
    j_import_torch_ckpt(ref, str(tmp_path / "jax.msgpack"))
    got = _lists(load_checkpoint(str(tmp_path / "ours.msgpack")))
    _assert_trees_equal(got, _lists(load_checkpoint(str(tmp_path / "jax.msgpack"))))
    _assert_trees_equal(_lists(ours), got)
    assert ("parse" in got["nerf_fine"]) == (n_classes > 0)
    # the port's field takes every tensor, the semantic head included
    net = load_ckpt(NeRF(NeRFConfig(n_classes=n_classes),
                         generator=torch.Generator().manual_seed(5)),
                    str(tmp_path / "ours.msgpack"), "nerf_fine")
    sd = _torch_nerf_module(1, n_classes).state_dict()
    assert torch.equal(net.xyz_layers[4].weight, sd["xyz_encoding_5.0.weight"])
    if n_classes:
        assert torch.equal(net.parse[1].weight, sd["parse.1.weight"])


def test_imported_fields_render_what_jax_renders(tmp_path, rng):
    ref = _reference_ckpt(str(tmp_path / "ref.ckpt"))
    import_torch_ckpt(ref, str(tmp_path / "ours.msgpack"))
    j_import_torch_ckpt(ref, str(tmp_path / "jax.msgpack"))
    models = {k: load_ckpt(NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(s)),
                           str(tmp_path / "ours.msgpack"), f"nerf_{k}")
              for s, k in enumerate(("coarse", "fine"))}
    jcfg = JNeRFConfig()
    jparams = {k: j_load_ckpt(numpy_tree(init_nerf, jcfg, seed=s), str(tmp_path / "jax.msgpack"),
                              f"nerf_{k}") for s, k in enumerate(("coarse", "fine"))}

    n = 32
    o = rng.standard_normal((n, 3)).astype(np.float32) * 0.2
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], -1)
    rkw = dict(n_samples=24, n_importance=8, perturb=0.0, noise_std=0.0, white_back=True)
    want = j_render_rays(jparams, jnp.asarray(rays), JRenderConfig(**rkw), None, nerf_cfg=jcfg)
    with torch.no_grad():
        got = render_rays(models, torch.from_numpy(rays), RenderConfig(**rkw))
    for k in ("rgb_coarse", "rgb_fine", "depth_fine"):
        close = np.isclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-4)
        assert close.mean() > 0.95, f"{k}: {close.mean():.3f}"


# -- the scene and the oracle ----------------------------------------------------------

def test_scene_equals_fast_frontier():
    for sph_a, sph_b in zip(scene.SPHERES, fast_frontier.SPHERES):
        for a, b in zip(sph_a, sph_b):
            assert np.array_equal(a, b)
    assert np.array_equal(scene.LIGHT, fast_frontier.LIGHT)
    for k in range(3):
        eye = 4.0 * np.array([np.cos(0.7 + k), np.sin(0.7 + k), 0.3 * k - 0.2])
        rot = scene.look_at(eye)
        assert np.array_equal(rot, fast_frontier.look_at(eye))
        rays = scene.make_rays(rot, eye, 12, 10, 14.0)
        assert np.array_equal(rays, fast_frontier.make_rays(rot, eye, 12, 10, 14.0))
        assert np.array_equal(scene.trace_gt(rays[:, :3], rays[:, 3:6]),
                              fast_frontier.trace_gt(rays[:, :3], rays[:, 3:6]))


def test_oracle_equals_the_parity_test_oracle(rng):
    trees = {k: nerf_to_jax(NeRF(NeRFConfig(**NARROW),
                                 generator=torch.Generator().manual_seed(s)).state_dict())
             for s, k in enumerate(("coarse", "fine"))}
    n = 40
    d = rng.standard_normal((n, 3)).astype(np.float32)
    rays = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)).astype(np.float32) * 0.2, d,
         np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1))
    with torch.no_grad():
        got = oracle.torch_render(trees, rays, 16, 8, True)
        want = jax_parity_test.torch_render(trees, rays, 16, 8, True)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- psnr_parity ----------------------------------------------------------------------

JAX_ROW_KEYS = {"pose", "torch_oracle_psnr", "torch_oracle_s"} | {
    f"{n}_{m}" for n in ("jnp_f32", "jnp_bf16", "fused")
    for m in ("psnr", "delta_db", "agreement_db")}


def test_psnr_parity_toy_run(tmp_path, monkeypatch):
    monkeypatch.setattr(psnr_parity, "BATCH", 32)
    out = str(tmp_path / "parity" / "psnr_parity.json")
    before = dict(fused_mlp.LAUNCHES)
    psnr_parity.main(["--steps", "3", "--train_hw", "8", "--hw", "8", "--poses", "1",
                      "--device", "cpu", "--out", out])
    assert fused_mlp.LAUNCHES == before   # K1's plain version on the CPU
    with open(out) as f:
        res = json.load(f)
    assert res["hw"] == 8 and res["steps"] == 3 and len(res["rows"]) == 1
    row = res["rows"][0]
    assert JAX_ROW_KEYS <= set(row)
    for k, v in row.items():
        if k != "card":
            assert math.isfinite(v), k
    assert os.path.exists(str(tmp_path / "parity" / "parity_ref.ckpt"))


def test_export_torch_ckpt_equals_jax(tmp_path):
    from tools.psnr_parity import export_torch_ckpt as j_export

    params = {k: nerf_to_jax(NeRF(NeRFConfig(**NARROW),
                                  generator=torch.Generator().manual_seed(s)).state_dict())
              for s, k in enumerate(("coarse", "fine"))}
    psnr_parity.export_torch_ckpt(params, str(tmp_path / "ours.ckpt"))
    j_export(params, str(tmp_path / "jax.ckpt"))
    got = torch.load(str(tmp_path / "ours.ckpt"))["state_dict"]
    want = torch.load(str(tmp_path / "jax.ckpt"))["state_dict"]
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- vis_log --------------------------------------------------------------------------

@pytest.mark.parametrize("with_step", [True, False])
def test_read_metric_equals_jax_vis_log(tmp_path, monkeypatch, with_step):
    import matplotlib.pyplot as plt

    import vis_log as j_vis_log

    path = str(tmp_path / "log.csv")
    with open(path, "w") as f:
        f.write(("step," if with_step else "") + "train/psnr,train/loss\n")
        for i in range(7):
            psnr_v = "" if i == 3 else f"{10 + 0.5 * i:.3f}"
            f.write((f"{100 * i}," if with_step else "") + f"{psnr_v},{1.0 / (i + 1):.5f}\n")
    seen = []
    monkeypatch.setattr(plt, "plot", lambda x, y, *a, **k: seen.append((list(x), list(y))))
    j_vis_log.main(path, "train/psnr", str(tmp_path / "jax.jpg"))
    assert read_metric(path, "train/psnr") == seen[0]
    with pytest.raises(ValueError):
        read_metric(path, "val/psnr")
