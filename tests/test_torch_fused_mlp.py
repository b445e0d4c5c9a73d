"""The port's fused NeRF field (plain version, which the wrappers run on the
CPU) and `render_rays_fused` against the JAX package's Pallas kernel, run in
interpret mode with the tile shrunk as tests/test_fused_mlp.py does, and
against the JAX `apply_nerf` at bf16 compute.

Tolerance atol 2e-3 / rtol 1e-2 for the field (the JAX kernel tests' own
bar): bf16 operands and f32 accumulation on both sides, so only the
summation order and the cos = sin(x + pi/2) phase trick of the TPU kernel
differ. The slice as a whole: atol 5e-3 / rtol 2e-2.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig, RenderConfig
from nerf_siren_tpu.models.embedding import positional_encoding as jpe
from nerf_siren_tpu.models.nerf import apply_nerf, init_nerf
from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
from nerf_siren_tpu.render.fused import render_rays_fused as j_render_rays_fused
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as tfm
from nerf_siren_tpu_torch.render.fused import render_rays_fused
from tests.test_torch_rendering import with_density

SMALL = NeRFConfig(depth=5, width=128)
TOL = dict(atol=2e-3, rtol=1e-2)


@pytest.fixture(scope="module", autouse=True)
def small_tile():
    old = jfm.TILE_N
    jfm.TILE_N = 128  # keep interpreter-mode runs of the JAX kernel fast
    yield
    jfm.TILE_N = old


def _torch_model(params):
    model = NeRF(SMALL)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def field():
    params = init_nerf(jax.random.PRNGKey(0), SMALL)
    return params, jfm.pack_nerf_params(params, SMALL), tfm.pack_nerf_params(_torch_model(params))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return xyz, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_sigma_matches_jax_kernel(field):
    params, jpacked, tpacked = field
    xyz, _ = _points(200, 1)   # not a multiple of the tile
    ref = np.asarray(jfm.fused_nerf_sigma(jpacked, jnp.asarray(xyz), depth=5, skips=(4,)))
    got = tfm.fused_nerf_sigma(tpacked, torch.from_numpy(xyz)).numpy()
    assert got.shape == ref.shape == (200, 1)
    np.testing.assert_allclose(got, ref, **TOL)


def test_full_matches_jax_kernel(field):
    params, jpacked, tpacked = field
    xyz, d = _points(130, 2)
    ref = np.asarray(jfm.fused_nerf_full(jpacked, jnp.asarray(xyz), jnp.asarray(d),
                                         depth=5, skips=(4,)))
    got = tfm.fused_nerf_full(tpacked, torch.from_numpy(xyz), torch.from_numpy(d)).numpy()
    assert got.shape == ref.shape == (130, 4)
    np.testing.assert_allclose(got, ref, **TOL)
    assert got[:, :3].min() >= 0 and got[:, :3].max() <= 1


@pytest.mark.parametrize("full", [False, True])
def test_plain_field_matches_apply_nerf_bf16(field, full):
    """Checks the W_comb fold (sanctioned ~1e-4 delta) against the unfolded
    MLP at bf16 compute."""
    params, _, tpacked = field
    xyz, d = _points(96, 3)
    ref = np.asarray(apply_nerf(params, jpe(jnp.asarray(xyz), 10),
                                jpe(jnp.asarray(d), 4) if full else None,
                                cfg=SMALL, compute_dtype=jnp.bfloat16))
    if full:
        got = tfm.fused_nerf_full(tpacked, torch.from_numpy(xyz), torch.from_numpy(d))
    else:
        got = tfm.fused_nerf_sigma(tpacked, torch.from_numpy(xyz))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_render_rays_fused_matches_jax(field):
    """The slice as a whole: coarse sigma pass -> sample_pdf -> fine pass,
    distinct coarse/fine weights, white background."""
    params = with_density(field[0])
    rng = np.random.default_rng(1)
    n = 24
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
                           rng.normal(size=(n, 3)).astype(np.float32),
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    cfg = RenderConfig(n_samples=8, n_importance=8, noise_std=0.0, perturb=0.0,
                       white_back=True, test_time=True)
    fine = with_density(init_nerf(jax.random.PRNGKey(7), SMALL))
    ref = j_render_rays_fused(jfm.pack_model_params({"coarse": params, "fine": fine}, SMALL),
                              jnp.asarray(rays), cfg, nerf_cfg=SMALL)
    got = render_rays_fused(
        tfm.pack_model_params({"coarse": _torch_model(params), "fine": _torch_model(fine)}),
        torch.from_numpy(rays), cfg)
    assert set(got) == set(ref) == {"opacity_coarse", "rgb_fine", "depth_fine", "opacity_fine"}
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=5e-3, rtol=2e-2,
                                   err_msg=k)


def test_render_rays_fused_rejects_non_eval_configs(field):
    _, _, tpacked = field
    rays = torch.zeros((2, 8))
    for cfg in (RenderConfig(n_samples=8, n_importance=8, noise_std=0.0),
                RenderConfig(n_samples=8, n_importance=0, noise_std=0.0, test_time=True),
                RenderConfig(n_samples=8, n_importance=8, noise_std=1.0, test_time=True)):
        with pytest.raises(ValueError, match="test_time"):
            render_rays_fused({"coarse": tpacked, "fine": tpacked}, rays, cfg)
