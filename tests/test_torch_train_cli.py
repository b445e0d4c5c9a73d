"""The port's training CLI (`python -m nerf_siren_tpu_torch.train`) on the
CPU: one tiny epoch on the synthetic Blender scene of
`tests/datasets_synthetic.py` with the full-width field, then both evals
(the port's and the JAX package's) read the checkpoint it wrote; a resumed
run ends where the uninterrupted one ends; `--pretrained` warm-starts from
a JAX-written checkpoint; flags and devices the port does not serve are
refused.

Tolerances: the two evals of the port-trained checkpoint agree within
0.1 dB of mean PSNR and 2/255 per pixel (float32 on both sides, as in
`test_torch_eval.py`); a resume reproduces the uninterrupted run exactly
(the same float32 CPU arithmetic in the same order).
"""
import glob
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from nerf_siren_tpu_torch.train import main as train_main
from nerf_siren_tpu_torch.opt import get_opts as train_opts
from nerf_siren_tpu_torch.training.checkpoints import load_checkpoint
from tests.datasets_synthetic import make_blender_dataset

HW = 16
# 6 train images of 16x16 = 1536 rays: 2 steps of 768 rays per epoch
TRAIN_ARGS = ["--dataset_name", "blender", "--img_wh", str(HW), str(HW),
              "--N_samples", "8", "--N_importance", "8", "--batch_size", "768",
              "--lr", "1e-3", "--device", "cpu"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_dataset(str(tmp_path_factory.mktemp("scene")), hw=HW)


def _in(cwd, fn, *args):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return fn(*args)
    finally:
        os.chdir(old)


def _train(cwd, root, *extra):
    return _in(cwd, train_main, train_opts(["--root_dir", root, *TRAIN_ARGS, *extra]))


def _ckpts(cwd, exp):
    return sorted(glob.glob(str(cwd / "ckpts" / exp / "*.msgpack")))


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_one_epoch_then_both_evals_read_the_checkpoint(tmp_path, scene, backend):
    """`fused` runs K2's plain version here (CPU tensors)."""
    from eval import get_opts as jax_eval_opts, main as jax_eval_main
    from nerf_siren_tpu_torch.eval import get_opts as eval_opts, main as eval_main

    state = _train(tmp_path, scene, "--num_epochs", "1", "--exp_name", backend,
                   "--train_backend", backend)
    assert state.step == 2
    (path,) = _ckpts(tmp_path, backend)
    assert os.path.basename(path) == "epoch=0-step=2.msgpack"
    raw = load_checkpoint(path)
    assert int(raw["step"]) == 2 and int(raw["epoch"]) == 1
    assert set(raw["params"]) == {"nerf_coarse", "nerf_fine"}

    common = ["--root_dir", scene, "--dataset_name", "blender", "--split", "test",
              "--img_wh", str(HW), str(HW), "--N_samples", "8", "--N_importance", "8",
              "--ckpt_path", path, "--scene_name", "s", "--renderer", "exact",
              "--compute_dtype", "float32"]
    (tmp_path / "jax").mkdir()
    port_psnr = _in(tmp_path, eval_main, eval_opts(common + ["--device", "cpu"]))
    jax_psnr = _in(tmp_path / "jax", jax_eval_main, jax_eval_opts(common))
    assert np.isfinite(port_psnr) and abs(port_psnr - jax_psnr) < 0.1
    for name in ("000.png", "001.png"):
        a = imageio.imread(tmp_path / "results" / "blender" / "s" / name).astype(int)
        b = imageio.imread(tmp_path / "jax" / "results" / "blender" / "s" / name).astype(int)
        assert np.abs(a - b).max() <= 2, name


def test_resume_ends_where_the_uninterrupted_run_ends(tmp_path, scene):
    _train(tmp_path, scene, "--num_epochs", "2", "--exp_name", "whole")
    first, last = _ckpts(tmp_path, "whole")
    assert os.path.basename(first) == "epoch=0-step=2.msgpack"
    state = _train(tmp_path, scene, "--num_epochs", "2", "--exp_name", "resumed",
                   "--ckpt_path", first)
    assert state.step == 4
    (resumed,) = _ckpts(tmp_path, "resumed")
    a, b = load_checkpoint(last), load_checkpoint(resumed)
    for model in ("nerf_coarse", "nerf_fine"):
        for la, lb in zip(a["params"][model]["xyz_layers"], b["params"][model]["xyz_layers"]):
            np.testing.assert_array_equal(la["kernel"], lb["kernel"])
        np.testing.assert_array_equal(a["params"][model]["rgb"]["kernel"],
                                      b["params"][model]["rgb"]["kernel"])
        np.testing.assert_array_equal(a["opt_state"]["mu"][model]["sigma"]["kernel"],
                                      b["opt_state"]["mu"][model]["sigma"]["kernel"])


def test_pretrained_warm_starts_from_a_jax_checkpoint(tmp_path, scene):
    """`--pretrained` takes the weights of a JAX-written checkpoint (bit for
    bit) and starts a fresh optimizer at step 0."""
    import jax
    from nerf_siren_tpu.config import NeRFConfig
    from nerf_siren_tpu.models.nerf import init_nerf
    from nerf_siren_tpu.training.checkpoints import save_checkpoint
    from nerf_siren_tpu_torch.convert import nerf_to_jax

    trees = {name: jax.tree_util.tree_map(np.asarray,
                                          init_nerf(jax.random.PRNGKey(seed), NeRFConfig()))
             for name, seed in (("nerf_coarse", 3), ("nerf_fine", 4))}
    path = str(tmp_path / "jax.msgpack")
    save_checkpoint(path, trees)
    state = _train(tmp_path, scene, "--num_epochs", "0", "--pretrained", path)
    assert state.step == 0 and state.opt_state["count"] == 0
    for key, name in (("coarse", "nerf_coarse"), ("fine", "nerf_fine")):
        got = nerf_to_jax(state.models[key].state_dict())
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(trees[name])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flags,names", [
    # slice 4 ported these: they parse now (names None), under their old ids
    pytest.param(["--mode", "d3"], None, id="flags0-slice 4"),
    # slice 5 ported EG3D training: it parses now, under its old id
    pytest.param(["--mode", "eg3d"], None, id="flags1-slice 5"),
    pytest.param(["--field", "siren"], None, id="flags2-slice 4"),
    (["--train_backend", "culled_fused"], "slice 6 (culled"),
    (["--multihost"], "slice 6"),
    (["--num_chips", "4"], "slice 6"),
    pytest.param(["--dataset_name", "replica"], None, id="flags6-slice 4"),
])
def test_unported_flags_name_their_roadmap_slice(capsys, flags, names):
    """A flag value that a later slice brings is refused with that slice's
    name; the values slices 4 and 5 brought parse."""
    if names is None:
        assert getattr(train_opts(["--root_dir", "unused", *flags]), flags[0][2:]) == flags[1]
        return
    with pytest.raises(SystemExit):
        train_opts(["--root_dir", "unused", *flags])
    assert names in capsys.readouterr().err


def test_entry_points_refuse_a_missing_card(tmp_path, scene):
    """Both CLIs default to --device cuda and fail without a card instead of
    running on the CPU."""
    from nerf_siren_tpu_torch.eval import get_opts as eval_opts, main as eval_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    assert train_opts(["--root_dir", scene]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        _in(tmp_path, train_main, train_opts(["--root_dir", scene, "--num_epochs", "1"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        _in(tmp_path, eval_main, eval_opts(["--root_dir", scene, "--ckpt_path", "x"]))
