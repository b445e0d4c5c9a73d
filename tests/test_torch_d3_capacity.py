"""`--point_capacity`, defined once (`opt.py::add_point_capacity`) for the
train and eval CLIs: both parse it with the JAX package's default, and the
train CLI's `--mode d3` system renders every cloud, in its steps and its
validation, at the capacity the flag gives."""
import os

import pytest

from nerf_siren_tpu_torch import eval as port_eval
from nerf_siren_tpu_torch import opt
from nerf_siren_tpu_torch.training import semantic_system
from tests.datasets_synthetic import make_blender_cls_dataset
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("flags,want", [([], 8192), (["--point_capacity", "77"], 77)])
def test_point_capacity_is_one_flag_of_both_clis(flags, want):
    assert opt.get_opts(["--root_dir", "x", *flags]).point_capacity == want
    assert port_eval.get_opts(["--root_dir", "x", "--ckpt_path", "y", *flags]).point_capacity \
        == want


def test_train_cli_point_capacity_reaches_the_system(tmp_path, monkeypatch):
    from nerf_siren_tpu_torch.train import main

    root = make_blender_cls_dataset(str(tmp_path / "scene"), n_train=1, hw=8)
    seen = []
    inner = semantic_system.render_rays_3d

    def render(*args, **kwargs):
        seen.append(kwargs["point_capacity"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(semantic_system, "render_rays_3d", render)
    monkeypatch.chdir(tmp_path)
    state = main(opt.get_opts([
        "--root_dir", root, "--mode", "d3", "--dataset_name", "blender_cls_ib",
        "--loss_type", "msenll", "--point_capacity", "37", "--img_wh", "8", "8",
        "--N_samples", "4", "--N_importance", "4", "--num_epochs", "1", "--batch_size", "32",
        "--device", "cpu", "--exp_name", "cap"]))
    assert state.step == 2 and os.path.isdir(tmp_path / "ckpts" / "cap")
    assert len(seen) >= 3 and set(seen) == {37}   # two steps and the validation's tiles
