"""The port's CLIs in `--mode d3` and with `--field siren` on the CPU: the
eval CLI's semantic path (exact and fast) against the JAX package's
`eval.py --mode d3` on one JAX-written checkpoint, the class count read
from the checkpoint and its refusal, the train CLI's d3 / d3_ib (PointNet
and the voxel UNet) and SIREN runs with `--steps_per_dispatch` 1 and 10,
their checkpoints read by the JAX package, and K3's candidate limit refused
at parse time on the card (the CPU takes any count).

Tolerances and why:
- class maps (`r_<i>.png`, class id x 10): equal to JAX's at every pixel
  whose top-two margin of the port's composited log-probabilities exceeds
  MARGIN (exact 5e-3, fast 2e-2; at least half, and a twentieth, of the
  pixels lie above it), and at most 5% of the pixels differ at all. The
  fields run on bf16 operands summed in another order (and on the fast
  path K3's plain march moves a survivor's depth by O(eps),
  tests/test_torch_fast_eval.py), which moves the weights, so the class
  log-probabilities (measured: exact, 1 pixel of 512 differs, at a margin
  of 1.6e-3 where the median pixel's is 0.13; fast, 9 of 512, the largest
  margin 6.6e-3 where the median is 0.004: a random field with 8
  survivors a ray composites little).
- rgb frames within 2/255 (exact) and 32/255 (fast) of JAX's, as the
  normal-mode CLI tests hold them; the same output files.
- the train CLI: the `--steps_per_dispatch 10` checkpoint equal to the
  `--steps_per_dispatch 1` one bit for bit (the grouped loop is the
  steps); the JAX loader reads its trees exactly.
"""
import glob
import os

import imageio.v2 as imageio
import numpy as np
import jax
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig as JNeRFConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.models.pointnet import init_pointnet_dense_cls
from nerf_siren_tpu.models.siren import init_siren_nerf
from nerf_siren_tpu.models.voxel_unet import init_voxel_unet
from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.training import checkpoints as jckpt
from nerf_siren_tpu_torch.convert import points_to_jax, siren_to_jax
from nerf_siren_tpu_torch.ops.kernels.proxy_march import MAX_CANDIDATES
from nerf_siren_tpu_torch.render import fast
from tests.datasets_synthetic import make_blender_cls_dataset
from tests.test_torch_eval import _run
from tests.test_torch_semantic import numpy_tree, one_torch_thread  # noqa: F401

MARGIN = {"exact": 5e-3, "fast": 2e-2}
SURE = {"exact": 0.5, "fast": 0.05}   # the least share of pixels above MARGIN
RGB_ATOL = {"exact": 2, "fast": 32}


@pytest.fixture(scope="module")
def scene_and_ckpt(tmp_path_factory):
    """A 16x16 Blender scene with class labels and a JAX-written checkpoint
    of full-width random fields and a 6-class PointNet."""
    root = make_blender_cls_dataset(str(tmp_path_factory.mktemp("scene")), n_train=2, hw=16)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "d3.msgpack")
    jckpt.save_checkpoint(ckpt, {
        "nerf_coarse": numpy_tree(init_nerf, JNeRFConfig(), seed=12),
        "nerf_fine": numpy_tree(init_nerf, JNeRFConfig(), seed=13),
        "points": numpy_tree(init_pointnet_dense_cls, 6, 6, seed=14)})
    return root, ckpt


@pytest.fixture
def tiles(monkeypatch):
    monkeypatch.setattr(jfm, "TILE_N", 128)
    monkeypatch.setattr(jpm, "TILE_R", 256)
    monkeypatch.setattr(fast, "TILE_R", 256)


@pytest.mark.parametrize("renderer", ["exact", "fast"])
def test_d3_eval_cli_matches_jax(tmp_path, scene_and_ckpt, tiles, monkeypatch, capsys,
                                 renderer):
    """chunk 100 over 256 rays: two tiles of 100 and a last one of 56, which
    JAX pads with zero rays and the port does not (a zero ray's samples
    all weigh 0, so they are never valid cloud points)."""
    from eval import get_opts as jax_opts, main as jax_main
    from nerf_siren_tpu_torch import eval as port_eval

    root, ckpt = scene_and_ckpt
    common = ["--root_dir", root, "--dataset_name", "blender_cls_ib", "--split", "test",
              "--img_wh", "16", "16", "--N_samples", "8", "--N_importance", "8",
              "--ckpt_path", ckpt, "--scene_name", "d3", "--mode", "d3", "--renderer",
              renderer, "--chunk", "100", "--cls_threshold", "0", "--fast_candidates", "16",
              "--fast_keep", "8", "--fast_distill_steps", "5", "--fast_distill_batch", "256"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _run(jax_main, jax_opts, tmp_path / "jax", common)
    capsys.readouterr()
    frames = []
    make = port_eval.make_semantic_renderer

    def recording(*args, **kwargs):
        render = make(*args, **kwargs)

        def run(rays):
            out = render(rays)
            frames.append(out)
            return out
        return run

    monkeypatch.setattr(port_eval, "make_semantic_renderer", recording)
    _run(port_eval.main, port_eval.get_opts, tmp_path / "port", common + ["--device", "cpu"])
    assert "n_classes = 6 (checkpoint head)" in capsys.readouterr().out

    jax_dir = tmp_path / "jax" / "results" / "blender_cls_ib"
    port_dir = tmp_path / "port" / "results" / "blender_cls_ib"
    names = sorted(os.path.relpath(p, jax_dir) for p in glob.glob(str(jax_dir / "*" / "*")))
    assert names == sorted(os.path.relpath(p, port_dir)
                           for p in glob.glob(str(port_dir / "*" / "*")))
    assert "d3/r_1.png" in names and "d3_cls_map/1img_color.png" in names
    for i, out in enumerate(frames):
        cls = out["cls_fine"]
        top = cls.topk(2, dim=-1).values
        sure = (top[:, 0] - top[:, 1] > MARGIN[renderer]).numpy().reshape(16, 16)
        want = imageio.imread(jax_dir / "d3" / f"r_{i}.png")
        got = imageio.imread(port_dir / "d3" / f"r_{i}.png")
        np.testing.assert_array_equal(got, (cls.argmax(-1).numpy().reshape(16, 16) * 10))
        assert sure.mean() > SURE[renderer], sure.mean()
        np.testing.assert_array_equal(got[sure], want[sure])
        assert (got != want).mean() <= 0.05
        a = imageio.imread(jax_dir / "d3" / f"{i:03d}.png").astype(int)
        b = imageio.imread(port_dir / "d3" / f"{i:03d}.png").astype(int)
        assert np.abs(a - b).max() <= RGB_ATOL[renderer]


def test_d3_eval_cli_refuses_a_class_count_off_the_checkpoint(scene_and_ckpt, capsys):
    from nerf_siren_tpu_torch.eval import get_opts, infer_ckpt_classes, main

    root, ckpt = scene_and_ckpt
    assert infer_ckpt_classes(ckpt, "pointnet") == 6
    assert infer_ckpt_classes(ckpt, "conv3d") is None
    hp = get_opts(["--root_dir", root, "--dataset_name", "blender_cls_ib", "--img_wh", "16",
                   "16", "--ckpt_path", ckpt, "--mode", "d3", "--n_classes", "5",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="does not match the checkpoint's pointnet"):
        main(hp)
    with pytest.raises(SystemExit):
        get_opts(["--root_dir", root, "--ckpt_path", ckpt, "--mode", "d3", "--renderer",
                  "fast", "--fast_cull", "auto", "--device", "cpu"])
    assert "does not take --fast_cull" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["normal", "d3"])
@pytest.mark.parametrize("flag", ["--fast_candidates", "--fast_prepass"])
def test_k3_candidate_limit_is_refused_at_parse_time_on_the_card(capsys, mode, flag):
    """K3 once refused more than MAX_CANDIDATES a ray on the card at parse
    time; it takes any count now (a device scratch above the shared-memory
    row's cap), so the parser passes MAX_CANDIDATES + 1 and far more on
    `cuda` as on the CPU, on and off K3's route, and says nothing."""
    from nerf_siren_tpu_torch.eval import get_opts

    args = ["--root_dir", ".", "--ckpt_path", "x", "--renderer", "fast", "--mode", mode]
    for count in (MAX_CANDIDATES, MAX_CANDIDATES + 1, 1 << 20):
        for device in ("cuda", "cpu"):
            opts = get_opts(args + [flag, str(count), "--device", device])
            assert getattr(opts, flag[2:]) == count
    assert get_opts(args + [flag, str(MAX_CANDIDATES + 1), "--fast_select", "topk",
                            "--device", "cuda"])
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("cli", ["eval", "eval_eg3d"])
@pytest.mark.parametrize("flag", ["--fast_candidates", "--fast_prepass"])
def test_512_candidates_parse_on_the_card(cli, flag):
    """512 candidates a ray, above the 256 K3 once took, parse on `cuda`
    for both eval CLIs (the check reads the parsed options: no card needed)."""
    import importlib

    get_opts = importlib.import_module(f"nerf_siren_tpu_torch.{cli}").get_opts
    opts = get_opts(["--root_dir", ".", "--ckpt_path", "x", "--renderer", "fast", flag, "512",
                     "--device", "cuda"])
    assert getattr(opts, flag[2:]) == 512


def test_cpu_fast_cli_renders_300_candidates(tmp_path, scene_and_ckpt):
    """The plain march on the CPU takes more candidates than the card's
    shared-memory row holds (MAX_CANDIDATES + 1, on a 2 x 2 image: once
    300, above the card's 256 of then), the count K3 takes on the card from
    a device scratch."""
    from nerf_siren_tpu_torch.eval import get_opts, main

    root, ckpt = scene_and_ckpt
    psnr = _run(main, get_opts, tmp_path, [
        "--root_dir", root, "--dataset_name", "blender_cls_ib", "--img_wh", "2", "2",
        "--ckpt_path", ckpt, "--renderer", "fast", "--fast_candidates",
        str(MAX_CANDIDATES + 1), "--fast_keep", "8", "--fast_distill_steps", "5",
        "--fast_distill_batch", "256", "--fast_proxy_path", "none", "--device", "cpu"])
    assert np.isfinite(psnr)


# ---- the train CLI -----------------------------------------------------------------

def _train(tmp_path, root, name, *flags):
    from nerf_siren_tpu_torch.opt import get_opts
    from nerf_siren_tpu_torch.train import main

    return _run(main, get_opts, tmp_path, [
        "--root_dir", root, "--img_wh", "16", "16", "--N_samples", "8", "--N_importance",
        "8", "--num_epochs", "1", "--batch_size", "32", "--device", "cpu", "--exp_name",
        name, *flags])


@pytest.mark.parametrize("flags", [
    ["--mode", "d3", "--semantic_network", "pointnet"],
    ["--mode", "d3_ib", "--semantic_network", "conv3d"],
    ["--field", "siren", "--siren_box_warp", "4.4"],
], ids=["d3-pointnet", "d3_ib-conv3d", "siren"])
def test_train_cli_new_fields_group_as_they_step(tmp_path, scene_and_ckpt, flags):
    """One epoch of 16 steps eagerly and as a group of 10 plus the tail of
    6: the same checkpoint; the JAX loader reads its trees (`points` for
    d3, the SIREN trees under `nerf_coarse` / `nerf_fine`)."""
    root, _ = scene_and_ckpt
    d3 = "--mode" in flags
    data = ["--dataset_name", "blender_cls_ib", "--loss_type", "msenll"] if d3 else \
        ["--dataset_name", "blender"]
    states = [_train(tmp_path, root, f"run{spd}", *flags, *data, "--steps_per_dispatch",
                     str(spd)) for spd in (1, 10)]
    assert states[0].step == states[1].step == 16
    paths = [glob.glob(str(tmp_path / "ckpts" / f"run{spd}" / "*.msgpack"))[0]
             for spd in (1, 10)]
    trees = [jckpt.load_checkpoint(p) for p in paths]
    for a, b in zip(jax.tree_util.tree_leaves(trees[0]), jax.tree_util.tree_leaves(trees[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if d3:
        assert os.path.exists(tmp_path / "mid_results" / "run1" / "step16_pred_map.png")
        template = (numpy_tree(init_pointnet_dense_cls, 6, 6) if "pointnet" in flags
                    else numpy_tree(init_voxel_unet, 7, 6))
        name, want = "points", points_to_jax(states[0].models["points"].state_dict())
    else:
        template = numpy_tree(init_siren_nerf, 256, 8, 100)
        name, want = "nerf_fine", siren_to_jax(states[0].models["fine"].state_dict())
    got = jckpt.load_ckpt(template, paths[0], name)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert all(torch.isfinite(p).all() for m in states[1].models.values()
               for p in m.parameters())
