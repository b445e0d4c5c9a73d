"""The port's checkpoint loader and eval CLI against the JAX package:
JAX writes the msgpack checkpoint, the port reads it, and both evals render
the same synthetic Blender scene."""
import glob
import os

import imageio.v2 as imageio
import numpy as np
import jax
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.training.checkpoints import save_checkpoint
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.training.checkpoints import (extract_model_state, load_checkpoint,
                                                         load_ckpt)
from tests.datasets_synthetic import make_blender_dataset


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("nested", [False, True])
def test_load_ckpt_reads_jax_checkpoint_bit_exact(tmp_path, nested):
    """save_checkpoint (flax msgpack) -> port load_ckpt: equal bit for bit,
    also for the semantic head and a full-resume file nesting 'params'."""
    cfg = NeRFConfig(depth=5, width=128, n_classes=4)
    coarse = _numpy(init_nerf(jax.random.PRNGKey(0), cfg))
    fine = _numpy(init_nerf(jax.random.PRNGKey(1), cfg))
    tree = {"nerf_coarse": coarse, "nerf_fine": fine}
    if nested:
        tree = {"params": tree, "step": np.asarray(7), "epoch": np.int32(2)}
    path = str(tmp_path / "ckpt.msgpack")
    save_checkpoint(path, tree)

    for name, params, seed in (("nerf_coarse", coarse, 5), ("nerf_fine", fine, 6)):
        model = load_ckpt(NeRF(cfg, generator=torch.Generator().manual_seed(seed)), path, name)
        want = nerf_from_jax(params)
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    raw = load_checkpoint(path)
    assert extract_model_state(raw, "nerf_fine")["sigma"]["bias"].dtype == np.float32
    if nested:
        assert int(raw["step"]) == 7 and int(raw["epoch"]) == 2


def test_load_ckpt_without_the_model_keeps_the_init(tmp_path, capsys):
    path = str(tmp_path / "other.msgpack")
    save_checkpoint(path, {"points": {"w": np.zeros(3, np.float32)}})
    cfg = NeRFConfig(depth=2, width=128)
    model = NeRF(cfg, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_ckpt(model, path, "nerf_coarse")
    assert "has no 'nerf_coarse'" in capsys.readouterr().out
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_psnr_matches_jax():
    from nerf_siren_tpu.training.metrics import psnr as jpsnr
    from nerf_siren_tpu_torch.training.metrics import psnr

    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(float(psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jpsnr(a, b)), rtol=1e-6)


@pytest.fixture(scope="module")
def scene_and_ckpt(tmp_path_factory):
    root = make_blender_dataset(str(tmp_path_factory.mktemp("scene")), hw=16)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "random.msgpack")
    save_checkpoint(ckpt, {"nerf_coarse": init_nerf(jax.random.PRNGKey(10), NeRFConfig()),
                           "nerf_fine": init_nerf(jax.random.PRNGKey(11), NeRFConfig())})
    return root, ckpt


def _run(main, get_opts, cwd, args):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(get_opts(args))
    finally:
        os.chdir(old)


@pytest.mark.parametrize("jax_dtype,port_renderer", [
    ("float32", "exact"),    # the same f32 math on both sides
    ("bfloat16", "fused"),   # the port's default renderer (plain field on the CPU)
])
def test_eval_cli_matches_jax(tmp_path, scene_and_ckpt, jax_dtype, port_renderer):
    """Frames within 2/255, mean PSNR within 0.1 dB of JAX `eval.py
    --renderer exact`, and the same output files."""
    from eval import get_opts as jax_opts, main as jax_main
    from nerf_siren_tpu_torch.eval import get_opts, main

    root, ckpt = scene_and_ckpt
    common = ["--root_dir", root, "--dataset_name", "blender", "--split", "test",
              "--img_wh", "16", "16", "--N_samples", "32", "--N_importance", "32",
              "--ckpt_path", ckpt, "--scene_name", "sphere", "--save_depth"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_psnr = _run(jax_main, jax_opts, tmp_path / "jax",
                    common + ["--renderer", "exact", "--compute_dtype", jax_dtype])
    port_psnr = _run(main, get_opts, tmp_path / "port",
                     common + ["--renderer", port_renderer, "--compute_dtype", jax_dtype,
                               "--device", "cpu"])
    assert np.isfinite(port_psnr) and abs(port_psnr - jax_psnr) < 0.1

    jax_dir = tmp_path / "jax" / "results" / "blender" / "sphere"
    port_dir = tmp_path / "port" / "results" / "blender" / "sphere"
    names = sorted(os.path.basename(p) for p in glob.glob(str(jax_dir / "*")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(str(port_dir / "*")))
    assert {"000.png", "001.png", "sphere.gif", "depth_000.pfm"} <= set(names)
    for name in ("000.png", "001.png"):
        a = imageio.imread(jax_dir / name).astype(int)
        b = imageio.imread(port_dir / name).astype(int)
        assert a.shape == b.shape == (16, 16, 3)
        assert np.abs(a - b).max() <= 2, name
