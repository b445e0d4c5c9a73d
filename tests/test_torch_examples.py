"""The port's examples (`nerf_siren_tpu_torch/examples/`) against the JAX
package's (`examples/`).

Tolerances and why:
- `export_unity_vol.write_vol`: byte-equal to the JAX example's writer on
  the same sigma grid (the JAX example's field, grid and checkpoint load
  are replaced by that grid; the writer is the same numpy).
- `mesh_threshold_sweep`: its vertex and face counts and largest-component
  shares equal those the JAX example prints, each example on its own
  package's sigma grid of one tiny checkpoint at `--N_grid 16`. The field
  is shaped so sigma spans the thresholds, and every grid value lies at
  least SIGMA_MARGIN from each threshold: the two packages' float32 grids
  differ by rounding only (~1e-5 here), so both fall on the same side.
- `render_single_image.render_view`: bit-equal to the port eval's exact
  renderer (`make_renderer(..., 'exact', compute_dtype=bf16)`) on the same
  rays: the same code path.
- the five `.sh` twins: each parses through the port's train or eval
  parser, with the same flags as the JAX script, and names no JAX CLI.
"""
import importlib.util
import os
import re
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig
from nerf_siren_tpu_torch.convert import nerf_to_jax
from nerf_siren_tpu_torch.examples import export_unity_vol, mesh_threshold_sweep
from nerf_siren_tpu_torch.examples import render_single_image
from nerf_siren_tpu_torch.extract_color_mesh import load_fine, predict_sigma_grid
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.training.checkpoints import save_checkpoint
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
THRESHOLDS = (2.0, 5.0, 10.0, 20.0, 50.0)   # the sweep's defaults
SIGMA_MARGIN = 1e-3
SHELLS = ("train_eg3d", "train_fern", "train_lego", "train_semantic", "val")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dense_ckpt(tmp_path_factory):
    """A full-width fine field whose sigma over the sweep's grid spans the
    thresholds: its sigma head rescaled so the raw sigma has mean 10 and
    spread 10 there."""
    from nerf_siren_tpu_torch.extract_color_mesh import grid_points
    from nerf_siren_tpu_torch.models.embedding import positional_encoding

    net = NeRF(NeRFConfig(), generator=torch.Generator().manual_seed(4))
    xyz = grid_points(mesh_threshold_sweep.get_opts(["--ckpt_path", "-", "--N_grid", "16"]))[0]
    with torch.no_grad():
        raw = net(positional_encoding(torch.from_numpy(xyz), 10))[:, 0]
        net.sigma.weight *= 10.0 / raw.std()
        net.sigma.bias.copy_((net.sigma.bias - raw.mean()) * 10.0 / raw.std() + 10.0)
    path = str(tmp_path_factory.mktemp("ckpt") / "dense.msgpack")
    save_checkpoint(path, {"nerf_fine": nerf_to_jax(net.state_dict())})
    return path


def test_sweep_counts_equal_jax_example(dense_ckpt, capsys, monkeypatch):
    args = mesh_threshold_sweep.get_opts(["--ckpt_path", dense_ckpt, "--N_grid", "16",
                                          "--device", "cpu"])
    sigma, spacing, origin = predict_sigma_grid(load_fine(dense_ckpt, "cpu"), args, "cpu")
    assert min(float(np.abs(sigma - t).min()) for t in THRESHOLDS) > SIGMA_MARGIN
    rows = mesh_threshold_sweep.sweep(sigma, THRESHOLDS, spacing, origin)
    assert sum(r[2] > 0 for r in rows) >= 3   # most thresholds cut the field

    jax_sweep = _jax_example("mesh_threshold_sweep")
    monkeypatch.setattr(sys, "argv", ["mesh_threshold_sweep.py", "--ckpt_path", dense_ckpt,
                                      "--N_grid", "16"])
    capsys.readouterr()
    jax_sweep.main()
    printed = [line.split() for line in capsys.readouterr().out.splitlines()
               if re.match(r"^\s+\d+\.\d\s+\d+\s+\d+\s+\d+%$", line)]
    assert [(float(t), int(v), int(f), p) for t, v, f, p in printed] == [
        (t, v, f, f"{frac:.0%}") for t, v, f, frac in rows]


def test_write_vol_bytes_equal_jax_writer(tmp_path, monkeypatch, rng):
    import extract_color_mesh as j_ecm
    import nerf_siren_tpu.models.nerf as j_nerf
    import nerf_siren_tpu.training.checkpoints as j_ckpt

    n = 12
    sigma = (rng.standard_normal((n, n, n)) * 60 + 40).astype(np.float32)
    spacing, origin = (0.2, 0.21, 0.19), (-1.2, -1.3, -1.1)
    jax_vol = _jax_example("export_unity_vol")
    monkeypatch.setattr(j_ecm, "predict_sigma_grid", lambda params, a: (sigma, spacing, origin))
    monkeypatch.setattr(j_nerf, "init_nerf", lambda *a, **k: None)
    monkeypatch.setattr(j_ckpt, "load_ckpt", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["export_unity_vol.py", "--ckpt_path", "unused",
                                      "--N_grid", str(n), "--sigma_max", "80",
                                      "--out", str(tmp_path / "jax.vol")])
    jax_vol.main()
    export_unity_vol.write_vol(str(tmp_path / "ours.vol"), sigma, spacing, origin, 80.0)
    ours = (tmp_path / "ours.vol").read_bytes()
    assert ours == (tmp_path / "jax.vol").read_bytes()
    assert len(ours) == 12 + 24 + n ** 3


def test_export_unity_vol_cli(dense_ckpt, tmp_path):
    out = str(tmp_path / "scene.vol")
    args = export_unity_vol.get_opts(["--ckpt_path", dense_ckpt, "--N_grid", "8",
                                      "--out", out, "--device", "cpu"])
    export_unity_vol.main(args)
    data = Path(out).read_bytes()
    assert np.frombuffer(data[:12], np.int32).tolist() == [8, 8, 8]
    np.testing.assert_allclose(np.frombuffer(data[12:36], np.float32),
                               [-1.2, -1.2, -1.2, 1.2, 1.2, 1.2], atol=1e-6)
    assert len(data) == 36 + 8 ** 3


def test_render_view_equals_the_eval_renderer(rng):
    from nerf_siren_tpu_torch.eval import make_renderer

    cfg = NeRFConfig(depth=4, width=32, skips=(2,))
    models = {k: NeRF(cfg, generator=torch.Generator().manual_seed(s))
              for s, k in enumerate(("coarse", "fine"))}
    n = 50
    d = rng.standard_normal((n, 3)).astype(np.float32)
    rays = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)).astype(np.float32) * 0.2, d,
         np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1))
    rcfg = RenderConfig(n_samples=16, n_importance=8, perturb=0.0, noise_std=0.0,
                        white_back=True, test_time=True, chunk=32)
    got = render_single_image.render_view(models, rays, rcfg)
    with torch.no_grad():
        want = make_renderer(models, rcfg, renderer="exact", compute_dtype=torch.bfloat16)(rays)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_render_single_image_cli(dense_ckpt, tmp_path, capsys):
    root = make_blender_dataset(str(tmp_path / "scene"), n_train=1, n_val=1, hw=16)
    out_dir = str(tmp_path / "single")
    render_single_image.main(render_single_image.get_opts(
        ["--root_dir", root, "--ckpt_path", dense_ckpt, "--img_wh", "16", "16",
         "--N_samples", "8", "--N_importance", "8", "--out_dir", out_dir, "--device", "cpu"]))
    assert "PSNR:" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out_dir, "rgb.png"))
    assert os.path.exists(os.path.join(out_dir, "depth.png"))


def _command(path):
    """(program and module, flags) of a script's one command."""
    text = Path(path).read_text().replace("\\\n", " ")
    lines = [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]
    assert len(lines) == 1, path
    words = shlex.split(lines[0])
    return words[:3] if words[1] == "-m" else words[:2], words[3 if words[1] == "-m" else 2:]


@pytest.mark.parametrize("name", SHELLS)
def test_shell_twin_parses_through_the_port(name, tmp_path):
    from nerf_siren_tpu_torch import opt
    from nerf_siren_tpu_torch.eval import get_opts as eval_opts

    prog, flags = _command(ROOT / "nerf_siren_tpu_torch" / "examples" / f"{name}.sh")
    jprog, jflags = _command(ROOT / "examples" / f"{name}.sh")
    assert flags == jflags
    assert jprog == ["python", "eval.py" if name == "val" else "train.py"]
    module = "nerf_siren_tpu_torch." + ("eval" if name == "val" else "train")
    assert prog == ["python", "-m", module]
    text = (ROOT / "nerf_siren_tpu_torch" / "examples" / f"{name}.sh").read_text()
    assert not re.search(r"\b(train|eval)\.py\b|nerf_siren_tpu\.", text)
    argv = [a.replace("$1", str(tmp_path)).replace("$2", str(tmp_path / "c.msgpack"))
            for a in flags]
    hp = (eval_opts if name == "val" else opt.get_opts)(argv)
    assert hp.root_dir == str(tmp_path)
