"""The port's mesh extraction and its last StyleGAN ops against the JAX
package, on the CPU: `ops/filtered_lrelu.py`, `ops/grid_sample.py::
grid_sample_3d`, the `mesh/` copies, and the two mesh CLIs
(`python -m nerf_siren_tpu_torch.extract_color_mesh` and
`extract_color_mesh_eg3d`) against the root JAX CLIs.

Tolerances and why:
- `filtered_lrelu`: atol 1e-5 of the output's scale; `grid_sample_3d`:
  atol 1e-6 against JAX and against `F.grid_sample`. The same float32
  operations; the FIR products sum in another order.
- the `mesh/` copies: bit-equal vertices and faces (the same numpy code);
  the PLY round trip exact (colours quantised to uint8 on both sides).
- `remap_linear` and `resize_nearest` against cv2 (which the JAX CLI
  calls; OpenCV 5 here, whose float-map remap interpolates unrounded
  coordinates with fused lerps): bit-equal.
- the NeRF CLI on `chip_smoke.py::ball_nerf_params` (a ball of density up
  to 15, full width: the CLI fixes NeRFConfig()) at N_grid 24, threshold
  5: equal faces, vertices within 1e-4 of the box (a vertex interpolates
  the float32 sigma grid between two grid points; reading 2.4e-7 on 622
  vertices), colours within 2/255 (uint8 in the PLY; float32 fusion and
  field queries on both sides; readings 0, 0 and 1 for fusion, normal and
  label).
- the EG3D CLI on the CLI's tiny config (planes 16^2, numpy weights,
  the threshold at the scene's median sigma): the same bars (readings:
  2.4e-5 of 2.0 on 10,680 vertices, colours 0). The synthesis' float32
  convolutions sum in another order than XLA's, and a vertex between two
  grid points of nearly equal sigma moves furthest.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.mesh import marching as jmarching
from nerf_siren_tpu.mesh import ply as jply
from nerf_siren_tpu.ops.filtered_lrelu import filtered_lrelu as jfiltered_lrelu
from nerf_siren_tpu.ops.grid_sample import grid_sample_3d as jgrid_sample_3d
from nerf_siren_tpu.training.checkpoints import save_checkpoint
from nerf_siren_tpu_torch.mesh import marching, ply
from nerf_siren_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from nerf_siren_tpu_torch.ops.grid_sample import grid_sample_3d
from nerf_siren_tpu_torch.ops.upfirdn2d import setup_filter
from tests.datasets_synthetic import make_blender_dataset
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---- the ops ------------------------------------------------------------------------

@pytest.mark.parametrize("up,down,padding,clamp", [(1, 1, 0, None), (2, 2, 3, 0.5),
                                                  (2, 1, (1, 2, 0, 1), None)])
def test_filtered_lrelu_matches_jax(up, down, padding, clamp):
    rng = np.random.default_rng(up + 3 * down)
    x = rng.normal(size=(2, 3, 9, 7)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    f = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32)
    fu, fd = setup_filter(t(f)), setup_filter(t(f))
    want = np.asarray(jfiltered_lrelu(jnp.asarray(x), jnp.asarray(fu.numpy()),
                                      jnp.asarray(fd.numpy()), jnp.asarray(b), up=up, down=down,
                                      padding=padding, clamp=clamp))
    got = filtered_lrelu(t(x), fu, fd, t(b), up=up, down=down, padding=padding,
                         clamp=clamp).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()), rtol=0)


def test_grid_sample_3d_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(2, 3, 5, 6, 7)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, size=(2, 200, 3)).astype(np.float32)
    want = np.asarray(jgrid_sample_3d(jnp.asarray(grid), jnp.asarray(coords)))
    got = grid_sample_3d(t(grid), t(coords)).numpy()
    assert got.shape == (2, 200, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ref = torch.nn.functional.grid_sample(t(grid), t(coords)[:, :, None, None, :],
                                          mode="bilinear", padding_mode="zeros",
                                          align_corners=False)[:, :, :, 0, 0].transpose(1, 2)
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-6, rtol=0)


# ---- mesh/ ---------------------------------------------------------------------------

def _blob_grid(n=20):
    lin = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (1.0 - np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2)
            + 0.5 * np.exp(-((x - 0.7) ** 2 + y ** 2 + (z + 0.7) ** 2) * 40)).astype(np.float32)


def test_mesh_copies_match_jax(tmp_path):
    grid = _blob_grid()
    kw = dict(spacing=(0.1, 0.12, 0.1), origin=(-1.0, -1.2, -1.0))
    jv, jf = jmarching.marching_tetrahedra(grid, 0.2, **kw)
    v, f = marching.marching_tetrahedra(grid, 0.2, **kw)
    assert len(v) > 100
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    for a, b in zip(marching.largest_connected_component(v, f),
                    jmarching.largest_connected_component(jv, jf)):
        np.testing.assert_array_equal(a, b)
    colors = np.random.default_rng(1).uniform(size=v.shape).astype(np.float32)
    ply.write_ply(str(tmp_path / "port.ply"), v, f, colors)
    jply.write_ply(str(tmp_path / "jax.ply"), v, f, colors)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    rv, rf, rc = ply.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(rv, v)
    np.testing.assert_array_equal(rf, f)
    np.testing.assert_array_equal(rc, (np.clip(colors, 0, 1) * 255).astype(np.uint8))


def test_remap_and_resize_match_cv2():
    import cv2

    from nerf_siren_tpu_torch.extract_color_mesh import remap_linear, resize_nearest

    rng = np.random.default_rng(2)
    image = rng.uniform(0, 255, size=(13, 17, 3)).astype(np.float32)
    x = rng.uniform(-0.5, 16.5, 3000).astype(np.float32)
    y = rng.uniform(-0.5, 12.5, 3000).astype(np.float32)
    x[:6] = [0.0, 16.0, 3.015625, 3.046875, 7.5, 15.99]   # edges and 1/64 ties
    want = cv2.remap(image, x[:, None], y[:, None], interpolation=cv2.INTER_LINEAR)[:, 0]
    np.testing.assert_array_equal(remap_linear(image, x, y), want)
    labels = rng.integers(0, 25, size=(23, 19)).astype(np.float64) * 10 / 10
    for w, h in ((8, 8), (16, 16), (40, 31)):
        np.testing.assert_array_equal(resize_nearest(labels, w, h),
                                      cv2.resize(labels, (w, h), interpolation=cv2.INTER_NEAREST))


# ---- the CLIs -------------------------------------------------------------------------

def _run(main, opts, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return main(opts)
    finally:
        os.chdir(old)


def _plys_close(a, b, box):
    va, fa, ca = ply.read_ply(a)
    vb, fb, cb = ply.read_ply(b)
    assert len(va) > 100 and va.shape == vb.shape
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_allclose(va, vb, atol=1e-4 * box, rtol=0)
    assert (ca is None) == (cb is None)
    if ca is not None:
        assert np.abs(ca.astype(int) - cb.astype(int)).max() <= 2
    return va, ca


@pytest.fixture(scope="module")
def ball_scene(tmp_path_factory):
    """The Blender sphere scene at 16^2 with label maps (ids x 10, 20^2, so
    the CLI resizes them) and a checkpoint of the ball field."""
    import imageio.v2 as imageio

    sys.path.insert(0, ROOT)
    from chip_smoke import ball_nerf_params
    from nerf_siren_tpu.config import NeRFConfig

    root = make_blender_dataset(str(tmp_path_factory.mktemp("scene")), n_train=3, hw=16)
    os.makedirs(os.path.join(root, "labels"))
    rng = np.random.default_rng(4)
    for name in os.listdir(os.path.join(root, "train")):
        lab = (rng.integers(0, 6, size=(20, 20)) * 10).astype(np.uint8)
        imageio.imwrite(os.path.join(root, "labels", name), lab)
    tree = ball_nerf_params(np.random.default_rng(0), NeRFConfig())
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "ball.msgpack")
    save_checkpoint(ckpt, {"nerf_coarse": tree, "nerf_fine": tree})
    return root, ckpt


@pytest.mark.parametrize("vis_type", ["fusion", "normal", "label"])
def test_extract_color_mesh_matches_jax(tmp_path, ball_scene, vis_type):
    from extract_color_mesh import get_opts as jax_opts, main as jax_main
    from nerf_siren_tpu_torch.extract_color_mesh import get_opts, main

    root, ckpt = ball_scene
    args = ["--root_dir", root, "--img_wh", "16", "16", "--ckpt_path", ckpt, "--N_grid", "24",
            "--sigma_threshold", "5", "--N_samples", "8", "--vis_type", vis_type,
            "--keep_largest", "--scene_name", vis_type]
    (tmp_path / "jax").mkdir()
    want = _run(jax_main, jax_opts(args), tmp_path / "jax")
    got = _run(main, get_opts(args + ["--device", "cpu"]), tmp_path)
    verts, colors = _plys_close(os.path.join(tmp_path, got), os.path.join(tmp_path / "jax", want),
                                2.4)
    r = np.linalg.norm(verts, axis=-1)   # the surface sigma = 5 of the ball sits at 2/3 R
    assert abs(np.median(r) - 0.4) < 0.05
    assert colors is not None and colors.shape == verts.shape


def test_extract_color_mesh_eg3d_matches_jax(tmp_path):
    from extract_color_mesh_eg3d import get_opts as jax_opts, main as jax_main
    from nerf_siren_tpu.render import triplane as J
    from nerf_siren_tpu_torch.extract_color_mesh_eg3d import get_opts, main
    from tests.test_torch_stylegan2 import numpy_eg3d_tree

    flags = ["--eg3d_plane_res", "16", "--eg3d_channel_base", "512", "--eg3d_channel_max", "32",
             "--eg3d_z_dim", "32", "--eg3d_box_warp", "4.0"]
    jcfg = J.TriPlaneConfig(z_dim=32, w_dim=32, plane_resolution=16, channel_base=512,
                            channel_max=32, rendering=J.RenderingOptions(box_warp=4.0))
    tree = numpy_eg3d_tree(jcfg, seed=5)
    ckpt = str(tmp_path / "eg3d.msgpack")
    save_checkpoint(ckpt, {"eg3d_renderer": tree})
    # the median raw sigma of this random scene over the cube: a surface through it
    args = ["--ckpt_path", ckpt, "--N_grid", "24", "--sigma_threshold", "-1.56",
            "--chunk", "16384", "--colorize"] + flags
    (tmp_path / "jax").mkdir()
    want = _run(jax_main, jax_opts(args), tmp_path / "jax")
    got = _run(main, get_opts(args + ["--device", "cpu"]), tmp_path)
    _, colors = _plys_close(os.path.join(tmp_path, got), os.path.join(tmp_path / "jax", want),
                            2.0)
    assert colors is not None
