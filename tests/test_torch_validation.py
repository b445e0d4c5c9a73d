"""The port's validation extras against the JAX package's: `ssim` and
`visualize_depth`, and the train CLI's validation writing the GT |
prediction | depth image.

Tolerances and why:
- `ssim` (mean): atol 1e-6. The same float32 arithmetic; only the 3-tap
  convolutions' sums may round in another order.
- `ssim` per pixel (reduction 'none'): atol 1e-5. The variances are
  differences of nearly equal filtered values (E[x^2] - E[x]^2), so a
  1-ulp difference in a filtered value (~6e-8 near 1) is divided by
  s1 + s2 + c2, which is ~1e-2 on these images.
- `visualize_depth`: bit-equal to the JAX package's cv2 `applyColorMap`
  (the same normalisation, then the same 256-entry JET table).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.training.metrics import ssim as j_ssim
from nerf_siren_tpu.utils.visualization import visualize_depth as j_visualize_depth
from nerf_siren_tpu_torch.training.metrics import ssim
from nerf_siren_tpu_torch.utils.visualization import JET_RGB, visualize_depth


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape,window", [((2, 3, 17, 13), 3), ((1, 3, 32, 32), 5),
                                          ((1, 1, 8, 9), 3)])
def test_ssim_matches_jax(shape, window):
    a, b = _images(shape, seed=shape[-1])
    got = ssim(torch.from_numpy(a), torch.from_numpy(b), window_size=window)
    ref = j_ssim(jnp.asarray(a), jnp.asarray(b), window_size=window)
    np.testing.assert_allclose(float(got), float(ref), rtol=0, atol=1e-6)
    got_map = ssim(torch.from_numpy(a), torch.from_numpy(b), window_size=window,
                   reduction="none")
    ref_map = j_ssim(jnp.asarray(a), jnp.asarray(b), window_size=window, reduction="none")
    assert got_map.shape == ref_map.shape
    np.testing.assert_allclose(got_map.numpy(), np.asarray(ref_map), rtol=0, atol=1e-5)
    assert float(ssim(torch.from_numpy(a), torch.from_numpy(a))) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("kind", ["random", "nan", "constant", "ramp", "inf"])
def test_visualize_depth_matches_cv2(kind):
    rng = np.random.default_rng(3)
    depth = {
        "random": rng.uniform(2, 6, (17, 23)),
        "nan": np.where(rng.uniform(size=(9, 11)) < 0.2, np.nan, rng.normal(size=(9, 11))),
        "constant": np.full((5, 4), 3.0),
        "ramp": np.linspace(0, 1, 256 * 3).reshape(24, 32),
        "inf": np.where(rng.uniform(size=(6, 6)) < 0.1, np.inf, rng.uniform(size=(6, 6))),
    }[kind].astype(np.float32)
    got = visualize_depth(depth)
    assert got.dtype == np.uint8 and got.shape == depth.shape + (3,)
    np.testing.assert_array_equal(got, j_visualize_depth(depth))
    np.testing.assert_array_equal(visualize_depth(torch.from_numpy(depth)), got)
    assert JET_RGB.shape == (256, 3)


def test_validate_writes_gt_prediction_and_depth(tmp_path):
    from nerf_siren_tpu_torch.config import NeRFConfig, RenderConfig, TrainConfig
    from nerf_siren_tpu_torch.datasets.blender import BlenderDataset
    from nerf_siren_tpu_torch.train import validate
    from nerf_siren_tpu_torch.training.system import NeRFSystem
    from tests.datasets_synthetic import make_blender_dataset

    class Writer:
        def __init__(self):
            self.images, self.scalars = {}, {}

        def add_image(self, tag, img, step, dataformats):
            assert dataformats == "HWC"
            self.images[tag] = (img, step)

        def add_scalar(self, tag, value, step):
            self.scalars[tag] = value

    scene = make_blender_dataset(str(tmp_path / "scene"), hw=8)
    val_ds = BlenderDataset(scene, split="val", img_wh=(8, 8))
    system = NeRFSystem(RenderConfig(n_samples=4, n_importance=4, white_back=True),
                        TrainConfig(), NeRFConfig(depth=2, width=32, skips=()),
                        steps_per_epoch=1, device="cpu")
    state = system.init_state(0)
    writer = Writer()
    val_loss, val_psnr = validate(system, state, val_ds, writer, 7, (8, 8))
    img, step = writer.images["val/GT_pred_depth"]
    assert step == 7 and img.shape == (8, 24, 3)
    out = system.render(state.models, val_ds[0]["rays"])
    np.testing.assert_array_equal(img[:, :8], val_ds[0]["rgbs"].reshape(8, 8, 3))
    np.testing.assert_array_equal(img[:, 8:16], np.clip(out["rgb_fine"].numpy().reshape(8, 8, 3),
                                                        0, 1))
    depth = j_visualize_depth(out["depth_fine"].numpy().reshape(8, 8))
    np.testing.assert_array_equal(img[:, 16:], depth.astype(np.float32) / 255.0)
    assert writer.scalars["val/loss"] == val_loss and writer.scalars["val/psnr"] == val_psnr
