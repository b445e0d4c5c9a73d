"""The port's models, weight conversion, searchsorted and sample_pdf against
the JAX package on the same inputs (made with numpy) and the same weights
(JAX `init_nerf`, carried across by `convert.py`)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig
from nerf_siren_tpu.models import embedding as jemb
from nerf_siren_tpu.models.nerf import apply_nerf, init_nerf
from nerf_siren_tpu.ops.sample_pdf import sample_pdf as jsample_pdf
from nerf_siren_tpu.ops.searchsorted import searchsorted as jsearchsorted
from nerf_siren_tpu_torch.convert import nerf_from_jax, nerf_to_jax
from nerf_siren_tpu_torch.models.embedding import positional_encoding
from nerf_siren_tpu_torch.models.layers import init_linear
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.sample_pdf import sample_pdf
from nerf_siren_tpu_torch.ops.searchsorted import searchsorted

SMALL = NeRFConfig(depth=5, width=128)


def torch_nerf(params, cfg):
    model = NeRF(cfg)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.mark.parametrize("n_freqs", [10, 4])
def test_positional_encoding_matches_jax(n_freqs):
    """Tolerance 1e-6: the same f32 sin/cos of exact power-of-two scalings
    (Blender-scale |x| <= 4, arguments up to 2^9 * 4)."""
    x = np.random.default_rng(0).uniform(-4, 4, (64, 5, 3)).astype(np.float32)
    ref = np.asarray(jemb.positional_encoding(jnp.asarray(x), n_freqs))
    got = positional_encoding(torch.from_numpy(x), n_freqs).numpy()
    assert got.shape == ref.shape == (64, 5, 3 * (2 * n_freqs + 1))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_classes", [0, 5])
@pytest.mark.parametrize("with_dirs", [False, True])
def test_nerf_matches_apply_nerf_f32(n_classes, with_dirs):
    """f32 MLP, atol 1e-4 / rtol 1e-4 (summation order only)."""
    cfg = NeRFConfig(depth=5, width=128, n_classes=n_classes)
    params = init_nerf(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-4, 4, (50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    xe, de = jemb.positional_encoding(jnp.asarray(xyz), 10), jemb.positional_encoding(jnp.asarray(d), 4)
    ref = np.asarray(apply_nerf(params, xe, de if with_dirs else None, cfg=cfg))
    with torch.no_grad():
        got = torch_nerf(params, cfg)(positional_encoding(torch.from_numpy(xyz), 10),
                                      positional_encoding(torch.from_numpy(d), 4)
                                      if with_dirs else None).numpy()
    assert got.shape == ref.shape == (50, (4 + n_classes) if with_dirs else 1)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_nerf_bf16_compute_matches_apply_nerf_bf16():
    """bf16 operands, f32 accumulation on both sides: atol 2e-3, rtol 1e-2
    (the same values; a different summation order can move a hidden unit
    to the neighbouring bf16 value)."""
    params = init_nerf(jax.random.PRNGKey(4), SMALL)
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-4, 4, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    ref = np.asarray(apply_nerf(params, jemb.positional_encoding(jnp.asarray(xyz), 10),
                                jemb.positional_encoding(jnp.asarray(d), 4),
                                cfg=SMALL, compute_dtype=jnp.bfloat16))
    with torch.no_grad():
        got = torch_nerf(params, SMALL)(positional_encoding(torch.from_numpy(xyz), 10),
                                        positional_encoding(torch.from_numpy(d), 4),
                                        compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-2)


def test_convert_round_trip_is_exact_and_lists_may_be_dicts():
    cfg = NeRFConfig(depth=5, width=128, n_classes=3)
    params = jax.tree_util.tree_map(np.asarray, init_nerf(jax.random.PRNGKey(5), cfg))
    sd = nerf_from_jax(params)
    assert sd["xyz_layers.4.weight"].shape == (128, 128 + 63)   # (out, in)
    back = nerf_to_jax(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    as_dicts = {**params, "xyz_layers": {str(i): v for i, v in enumerate(params["xyz_layers"])}}
    for k, v in nerf_from_jax(as_dicts).items():
        assert torch.equal(v, sd[k]), k
    assert set(NeRF(cfg).state_dict()) == set(sd)


def test_init_linear_is_seeded_torch_default_uniform():
    a = init_linear(63, 256, generator=torch.Generator().manual_seed(0))
    b = init_linear(63, 256, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    bound = 1 / np.sqrt(63)
    assert a.weight.shape == (256, 63)
    assert a.weight.abs().max() <= bound and a.weight.abs().max() > 0.9 * bound
    assert a.bias.abs().max() <= bound


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_matches_jax(side):
    rng = np.random.default_rng(3)
    seq = np.sort(rng.integers(0, 10, (6, 12)).astype(np.float32), -1)   # with ties
    vals = rng.integers(-1, 11, (6, 9)).astype(np.float32)
    ref = np.asarray(jsearchsorted(jnp.asarray(seq), jnp.asarray(vals), side))
    got = searchsorted(torch.from_numpy(seq), torch.from_numpy(vals), side).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.stack([np.searchsorted(s, v, side) for s, v in zip(seq, vals)]))
    with pytest.raises(ValueError):
        searchsorted(torch.from_numpy(seq), torch.from_numpy(vals), "middle")


def _tie_free_pdf_inputs(n_rays=32, n_bins=20):
    """Strictly increasing bins; weights with empty stretches (the eps floor
    and denom < eps paths) but CDF values away from the linspace u."""
    rng = np.random.default_rng(4)
    bins = np.cumsum(rng.uniform(0.05, 0.3, (n_rays, n_bins)), -1).astype(np.float32) + 2.0
    w = rng.uniform(0.0, 1.0, (n_rays, n_bins - 1)).astype(np.float32)
    w[:8, :10] = 0.0
    w[8:12] = 0.0
    return bins, w


@pytest.mark.parametrize("midpoint", [False, True])
@pytest.mark.parametrize("return_density", [False, True])
def test_sample_pdf_matches_jax(midpoint, return_density):
    """Deterministic modes, tolerance 1e-5 (tie-free CDFs: a tie may send a
    sample to the neighbouring bin, a sanctioned difference)."""
    bins, w = _tie_free_pdf_inputs()
    kw = dict(det=True, midpoint=midpoint, return_density=return_density)
    ref = jsample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, **kw)
    got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 24, **kw)
    if not return_density:
        ref, got = (ref,), (got,)
    for i, (r, g) in enumerate(zip(ref, got)):
        r, g = np.asarray(r), g.numpy()
        if i == 1 and not midpoint:
            # u = 1 ties with the CDF's last value, 1 +- 1 ulp by summation
            # order: the sample is the same, its bin's density may be 0
            r, g = r[:, :-1], g[:, :-1]
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5)


def test_sample_pdf_ignores_surplus_bins_and_random_mode_stays_in_range():
    bins, w = _tie_free_pdf_inputs()
    extra = np.concatenate([bins, bins[:, -1:] + 1.0], -1)
    tb, tw = torch.from_numpy(bins), torch.from_numpy(w)
    torch.testing.assert_close(sample_pdf(torch.from_numpy(extra), tw, 16, det=True),
                               sample_pdf(tb, tw, 16, det=True), rtol=0, atol=0)
    s = sample_pdf(tb, tw, 64, generator=torch.Generator().manual_seed(0))
    assert (s >= tb[:, :1]).all() and (s <= tb[:, -1:]).all()
    with pytest.raises(ValueError, match="generator"):
        sample_pdf(tb, tw, 8)
