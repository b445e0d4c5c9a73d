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


# a width the kernel takes beside 256, at the shortest depth JAX's pack takes
# with its one topology (the skip at 4)
WIDE = NeRFConfig(depth=5, width=384)


@pytest.mark.parametrize("full", [False, True])
def test_width_384_matches_jax_kernel(full):
    """At width 384 (one of the kernel's split widths), depth 5 with the skip
    at 4: the port's plain versions against JAX's Pallas kernel in
    interpret mode."""
    params = init_nerf(jax.random.PRNGKey(1), WIDE)
    model = NeRF(WIDE)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    jpacked, tpacked = jfm.pack_nerf_params(params, WIDE), tfm.pack_nerf_params(model)
    assert "k1_stream" in tpacked
    xyz, d = _points(130, 5)
    if full:
        ref = jfm.fused_nerf_full(jpacked, jnp.asarray(xyz), jnp.asarray(d), depth=5, skips=(4,))
        got = tfm.fused_nerf_full(tpacked, torch.from_numpy(xyz), torch.from_numpy(d))
    else:
        ref = jfm.fused_nerf_sigma(jpacked, jnp.asarray(xyz), depth=5, skips=(4,))
        got = tfm.fused_nerf_sigma(tpacked, torch.from_numpy(xyz))
    assert got.shape == ref.shape == (130, 4 if full else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


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


# ---- the kernel's weight stream (k1_stream) ----------------------------------

STREAM_CASES = [(8, (4,)), (3, (1,))]   # (depth, skips): the reference field, a short one


def width_id(width, ident):
    """A case's id at `width`: the width-256 ids are the ones they had when
    256 was the kernel's only width."""
    return ident if width == 256 else f"w{width}-{ident}"


@pytest.mark.parametrize("width,depth,skips", [
    pytest.param(w, d, s, id=width_id(w, f"{d}-skips{i}"))
    for w in tfm.KERNEL_WIDTHS for i, (d, s) in enumerate(STREAM_CASES)])
def test_k1_stream_unpacks_to_every_weight(width, depth, skips):
    """The plain inverse rebuilds every streamed weight of the pack exactly;
    W_dir's padding to 64 inputs is zero."""
    model = NeRF(NeRFConfig(depth=depth, width=width, skips=skips))
    packed = tfm.pack_nerf_params(model)
    emb_layers = [0, *skips]
    got = tfm.unpack_k1_stream(packed["k1_stream"], depth, emb_layers, width)
    expect = ({f"w{i}" for i in range(1, depth)} | {f"w{i}e" for i in emb_layers}
              | {"w_comb", "w_dir"})
    assert set(got) == expect
    for k in expect - {"w_dir"}:
        assert torch.equal(got[k], packed[k]), k
    assert torch.equal(got["w_dir"][:, :tfm.EMB_D], packed["w_dir"])
    assert not got["w_dir"][:, tfm.EMB_D:].any()


# n_trunk = 1 + (depth - 1) W / 64 + the skips: the reference field 30 trunk
# slices at width 256, depth 3 with the skip at 1 10 (16 / 6 at width 128,
# 44 / 14 at 384, 58 / 18 at 512); W / 64 + 1 direction slices
@pytest.mark.parametrize("width,depth,skips,n_trunk", [
    pytest.param(w, d, s, n, id=width_id(w, f"{d}-skips{i}-{n}"))
    for w in tfm.KERNEL_WIDTHS for i, (d, s) in enumerate(STREAM_CASES)
    for n in [1 + (d - 1) * w // 64 + len(s)]])
def test_k1_stream_order_and_swizzle(width, depth, skips, n_trunk):
    """The slice count and order documented in csrc/fused_mlp.cu, and each
    element where the 128-byte swizzle puts it: element (r, c) of a slice at
    r * 64 + ((c // 8) ^ (r % 8)) * 8 + c % 8."""
    packed = tfm.pack_nerf_params(NeRF(NeRFConfig(depth=depth, width=width, skips=skips)))
    sched = tfm.k1_schedule(depth, [0, *skips], width)
    trunk = [("w0e", 0)]
    for i in range(1, depth):
        trunk += ([(f"w{i}", c) for c in range(0, width, 64)]
                  + ([(f"w{i}e", 0)] if i in skips else []))
    assert len(trunk) == n_trunk
    n_dir = width // 64 + 1
    assert sched == trunk + [("w_comb", c) for c in range(0, width, 64)] + [("w_dir", 0)]
    stream = packed["k1_stream"].view(torch.int16).numpy()
    assert stream.size == n_trunk * width * 64 + n_dir * (width // 2) * 64
    r, c = np.meshgrid(np.arange(width), np.arange(64), indexing="ij")
    off = 0
    for k, c0 in sched:
        w = torch.nn.functional.pad(packed[k], (0, max(0, 64 - packed[k].shape[1])))
        w = w.view(torch.int16).numpy()
        rows = w.shape[0]
        rr, cc = r[:rows], c[:rows]
        np.testing.assert_array_equal(stream[off + rr * 64 + ((cc // 8) ^ (rr % 8)) * 8 + cc % 8],
                                      w[:, c0: c0 + 64], err_msg=f"{k}[:, {c0}:]")
        off += rows * 64
    assert off == stream.size


def test_k1_stream_only_in_the_bf16_pack_at_the_kernel_width():
    """The bf16 pack carries k1_stream at every width the kernels take: the
    resident kernel's 128-512 and the wide kernel's every other multiple of
    128 (640 here, whose stream round-trips through `unpack_k1_stream`);
    none at 192, which JAX's pack refuses too; the int8 pack never."""
    from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as tk4

    assert tfm.KERNEL_WIDTHS == (128, 256, 384, 512)
    assert "k1_stream" in tfm.pack_nerf_params(NeRF(NeRFConfig()))
    assert "k1_stream" not in tk4.pack_nerf_params_int8(NeRF(NeRFConfig()))
    for width in (128, 384, 512, 640, 192):
        packed = tfm.pack_nerf_params(NeRF(NeRFConfig(depth=2, width=width, skips=())))
        assert ("k1_stream" in packed) == (width % 128 == 0), width
        assert tfm.takes_width(width) == (width % 128 == 0)
        assert tfm.resident(width, 8) == (width in tfm.KERNEL_WIDTHS)
    packed = tfm.pack_nerf_params(NeRF(NeRFConfig(depth=2, width=640, skips=())))
    got = tfm.unpack_k1_stream(packed["k1_stream"], 2, [0], 640)
    for k in ("w0e", "w1", "w_comb"):
        assert torch.equal(got[k], packed[k]), k
    assert torch.equal(got["w_dir"][:, :tfm.EMB_D], packed["w_dir"])


# the wide kernel's shapes (csrc/fused_mlp_wide.cu): widths above 512 at the
# reference depth, and depths below and above the resident kernels' 16 layers
WIDE_CASES = [(640, 8), (1024, 8), (128, 2), (128, 20)]


def wide_case(width, depth, seed):
    """A field of JAX's one topology (the skip at 4) at this width and depth:
    JAX's params, its pack and the port's pack of the same weights."""
    cfg = NeRFConfig(depth=depth, width=width)
    params = init_nerf(jax.random.PRNGKey(seed), cfg)
    model = NeRF(cfg)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return cfg, params, model


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("width,depth", WIDE_CASES, ids=[f"w{w}-d{d}" for w, d in WIDE_CASES])
def test_wide_shapes_match_jax_kernel(width, depth, full):
    """The plain versions (the wide kernel's function) at widths 640 and 1024
    (depth 8) and at depths 2 and 20 (width 128), 130 points, against JAX's
    Pallas kernel in interpret mode (`fused_sigma_t` / `fused_full_t` under
    `fused_nerf_sigma` / `fused_nerf_full`), within the module's field bar."""
    cfg, params, model = wide_case(width, depth, 11)
    jpacked, tpacked = jfm.pack_nerf_params(params, cfg), tfm.pack_nerf_params(model)
    assert "k1_stream" in tpacked
    assert tfm.resident(width, depth) == (width <= 512 and depth <= tfm.MAX_DEPTH)
    xyz, d = _points(130, 12)
    if full:
        ref = jfm.fused_nerf_full(jpacked, jnp.asarray(xyz), jnp.asarray(d), depth=depth,
                                  skips=cfg.skips)
        got = tfm.fused_nerf_full(tpacked, torch.from_numpy(xyz), torch.from_numpy(d))
    else:
        ref = jfm.fused_nerf_sigma(jpacked, jnp.asarray(xyz), depth=depth, skips=cfg.skips)
        got = tfm.fused_nerf_sigma(tpacked, torch.from_numpy(xyz))
    assert got.shape == ref.shape == (130, 4 if full else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
