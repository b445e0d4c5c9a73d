"""The port's compositing and `render_rays` against the JAX package, in
float32 with perturb=0 and noise_std=0 (torch and JAX draw different random
numbers), on the same rays and weights."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig, RenderConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.render import rendering as jr
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.render.rendering import (composite, render_rays,
                                                    render_rays_chunked, stratified_z_vals)

SMALL = NeRFConfig(depth=5, width=128)
ATOL = 1e-4


def with_density(params, sigma_bias=0.5):
    """A random-init field with density along every ray, so no interior
    coarse weight is eps-floored. Otherwise the u = 1 fine sample, which
    ties with the CDF's last value (1 +- 1 ulp, by summation order), can
    move by up to ~1e-3: the sanctioned CDF-tie delta, not a fault."""
    sigma = {"kernel": params["sigma"]["kernel"],
             "bias": params["sigma"]["bias"] + sigma_bias}
    return {**params, "sigma": sigma}


@pytest.fixture(scope="module")
def fields():
    params = {"coarse": with_density(init_nerf(jax.random.PRNGKey(0), SMALL)),
              "fine": with_density(init_nerf(jax.random.PRNGKey(1), SMALL))}
    models = {}
    for k, p in params.items():
        models[k] = NeRF(SMALL)
        models[k].load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, p)))
    return params, models


def _rays(n=32, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return np.concatenate([o, d, np.full((n, 1), 2, np.float32),
                           np.full((n, 1), 6, np.float32)], -1)


@pytest.mark.parametrize("white_back", [False, True])
def test_composite_matches_jax(white_back):
    rng = np.random.default_rng(1)
    sig = rng.normal(size=(16, 24)).astype(np.float32) * 3
    z = np.sort(rng.uniform(2, 6, (16, 24)), -1).astype(np.float32)
    dn = rng.uniform(0.5, 2, (16, 1)).astype(np.float32)
    rgb = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    ref = jr.composite(jnp.asarray(sig), jnp.asarray(z), jnp.asarray(dn), jnp.asarray(rgb),
                       white_back=white_back)
    got = composite(torch.from_numpy(sig), torch.from_numpy(z), torch.from_numpy(dn),
                    torch.from_numpy(rgb), white_back=white_back)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("n_samples,n_importance,white_back,test_time", [
    (64, 0, False, False),   # coarse only
    (64, 64, False, False),  # coarse + fine
    (64, 64, True, False),   # white background
    (64, 64, True, True),    # test-time sigma-only coarse pass
])
def test_render_rays_matches_jax(fields, n_samples, n_importance, white_back, test_time):
    """Tolerance atol 1e-4: f32 on both sides, summation order only."""
    params, models = fields
    cfg = RenderConfig(n_samples=n_samples, n_importance=n_importance, perturb=0.0,
                       noise_std=0.0, white_back=white_back, test_time=test_time)
    rays = _rays()
    ref = jr.render_rays(params, jnp.asarray(rays), cfg, None, nerf_cfg=SMALL)
    with torch.no_grad():
        got = render_rays(models, torch.from_numpy(rays), cfg, None)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_render_rays_chunked_matches_jax(fields):
    """A ragged last chunk (45 rays in chunks of 16) gives the same rays."""
    params, models = fields
    cfg = RenderConfig(n_samples=16, n_importance=16, perturb=0.0, noise_std=0.0,
                       white_back=True, test_time=True, chunk=16)
    rays = _rays(45, seed=2)
    ref = jr.render_rays_chunked(params, jnp.asarray(rays), cfg, None, nerf_cfg=SMALL)
    with torch.no_grad():
        got = render_rays_chunked(models, torch.from_numpy(rays), cfg)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_random_draws_come_from_the_generator(fields):
    """perturb / noise_std / random sample_pdf draw from the torch.Generator:
    one seed gives one render, and jittered depths stay in their strata."""
    _, models = fields
    cfg = RenderConfig(n_samples=16, n_importance=16, perturb=1.0, noise_std=1.0)
    rays = torch.from_numpy(_rays(8))
    with torch.no_grad():
        a = render_rays(models, rays, cfg, torch.Generator().manual_seed(3))
        b = render_rays(models, rays, cfg, torch.Generator().manual_seed(3))
        c = render_rays(models, rays, cfg, torch.Generator().manual_seed(4))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["rgb_fine"], c["rgb_fine"])

    near, far = torch.full((8, 1), 2.0), torch.full((8, 1), 6.0)
    z0 = stratified_z_vals(near, far, 16)
    z = stratified_z_vals(near, far, 16, perturb=1.0, generator=torch.Generator().manual_seed(5))
    mid = 0.5 * (z0[:, 1:] + z0[:, :-1])
    assert (z[:, 1:] >= mid).all() and (z[:, :-1] <= mid).all() and not torch.equal(z, z0)
