"""The port's C++ ray helper (`nerf_siren_tpu_torch/native`) against the JAX
package's (`nerf_siren_tpu/native`), and the port's datasets' rays against
JAX's on the synthetic Blender scene of `tests/datasets_synthetic.py`.

Both libraries are built here with g++ from the same source and flags, so
the tests ask for bit-equality (`np.array_equal`): each of the five
functions on the same inputs, and the rays of every split of the loaders,
which go through the helper by default in both packages. With the helper
switched off (`NERF_SIREN_TPU_NATIVE=0`) both packages' numpy rays are
bit-equal too, and the helper's rays stay within the bars of the JAX
package's `tests/test_native.py` of the numpy ones (rtol 1e-5, atol 1e-6:
the helper normalises with 1 / sqrt where numpy divides by the norm)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from nerf_siren_tpu import native as jnative
from nerf_siren_tpu.datasets import ray_utils as jrays
from nerf_siren_tpu.datasets.blender import BlenderDataset as JBlenderDataset
from nerf_siren_tpu_torch import native
from nerf_siren_tpu_torch.datasets import ray_utils
from nerf_siren_tpu_torch.datasets.blender import BlenderDataset
from tests.datasets_synthetic import make_blender_dataset

RAY_TOL = dict(rtol=1e-5, atol=1e-6)   # helper vs numpy (tests/test_native.py)


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not (native.available() and jnative.available()):
        pytest.skip(f"no C++ toolchain: {native.build_error()}")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_blender_dataset(str(tmp_path_factory.mktemp("blender")), hw=40)


def _c2w(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)


def test_library_is_built_in_the_package_build_dir():
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "nerf_siren_tpu_torch"


def test_ray_directions_equal_jax(rng):
    for h, w, f in ((30, 40, 35.0), (17, 9, 12.5)):
        assert np.array_equal(native.ray_directions(h, w, f), jnative.ray_directions(h, w, f))


def test_world_rays_equal_jax(rng):
    dirs = rng.normal(size=(23, 11, 3)).astype(np.float32)
    c2w = _c2w(rng)
    for got, want in zip(native.world_rays(dirs, c2w), jnative.world_rays(dirs, c2w)):
        assert np.array_equal(got, want)


def test_ndc_rays_equal_jax(rng):
    o, d = ray_utils.get_rays(ray_utils.get_ray_directions(24, 32, 30.0), _c2w(rng))
    for got, want in zip(native.ndc_rays(24, 32, 30.0, 1.0, o, d),
                         jnative.ndc_rays(24, 32, 30.0, 1.0, o, d)):
        assert np.array_equal(got, want)


def test_blend_rgba_white_equals_jax(rng):
    rgba = rng.integers(0, 256, (100, 4)).astype(np.uint8)
    assert np.array_equal(native.blend_rgba_white(rgba), jnative.blend_rgba_white(rgba))


def test_pack_rays_equals_jax(rng):
    o = rng.standard_normal((50, 3)).astype(np.float32)
    d = rng.standard_normal((50, 3)).astype(np.float32)
    assert np.array_equal(native.pack_rays(o, d, 2.0, 6.0), jnative.pack_rays(o, d, 2.0, 6.0))


def _rays(cls, root, split):
    ds = cls(root_dir=root, split=split, img_wh=(40, 40))
    if split == "train":
        return ds.all_rays
    return np.concatenate([ds[i]["rays"] for i in range(len(ds))])


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_blender_rays_equal_jax_bit_for_bit(scene, split):
    """Both loaders on the helper (the default): the same rays, bit for bit."""
    assert ray_utils._native() is not None and jrays._native() is not None
    assert np.array_equal(_rays(BlenderDataset, scene, split),
                          _rays(JBlenderDataset, scene, split))


@pytest.mark.parametrize("split", ["train", "val"])
def test_numpy_rays_without_the_helper(scene, split, monkeypatch):
    """`NERF_SIREN_TPU_NATIVE=0` in both packages: numpy rays, equal to JAX's
    numpy rays bit for bit and to the helper's within RAY_TOL."""
    on = _rays(BlenderDataset, scene, split)
    monkeypatch.setattr(ray_utils, "_USE_NATIVE", False)
    monkeypatch.setattr(jrays, "_USE_NATIVE", False)
    assert ray_utils._native() is None
    off = _rays(BlenderDataset, scene, split)
    assert np.array_equal(off, _rays(JBlenderDataset, scene, split))
    np.testing.assert_allclose(on, off, **RAY_TOL)
    assert not np.array_equal(on, off)   # the two routes round differently


@pytest.mark.parametrize("value,expected", [("0", False), ("1", True)])
def test_environment_switch(value, expected):
    out = subprocess.run(
        [sys.executable, "-c", "from nerf_siren_tpu_torch.datasets import ray_utils; "
                               "print(ray_utils._USE_NATIVE)"],
        env=dict(os.environ, NERF_SIREN_TPU_NATIVE=value), capture_output=True, text=True,
        check=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == str(expected)
