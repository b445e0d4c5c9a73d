"""The port's EG3D triplane renderer (`nerf_siren_tpu_torch/render/triplane.py`,
`ops/grid_sample.py`) against the JAX package's `render/triplane.py` and
`ops/grid_sample.py` on the same numpy inputs and weights.

Tolerances: projection, box limits and linspace 1e-6 (the projection is
exact); sampling 1e-5 of the features' scale (float32 corner weights,
summed in the same order); the ray marcher, stratified and importance
depths, the decoder 1e-5 (float32 elementwise math, reductions in another
order); `importance_render` and `eg3d_render` 1e-4 (as tests/test_triplane.py's
oracles: the sums of the decoder and the marcher in another order, moved
through the importance resampling). `sample_pdf` meets no eps-floored
bin here: `sample_importance` adds 0.01 to every smoothed weight."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from nerf_siren_tpu.ops import grid_sample as JG
from nerf_siren_tpu.render import triplane as J
from nerf_siren_tpu_torch.convert import eg3d_from_jax
from nerf_siren_tpu_torch.ops import grid_sample as TG
from nerf_siren_tpu_torch.render import triplane as T
from tests.test_torch_stylegan2 import TINY, numpy_eg3d_tree

GEOM_TOL = 1e-6
SAMPLE_TOL = 1e-5
STEP_TOL = 1e-5
RENDER_TOL = 1e-4
OPTS = dict(depth_resolution=12, depth_resolution_importance=8, ray_start=0.5, ray_end=4.0,
            box_warp=4.0)


def close(got, want, tol, scale=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max|d| {err:.3e} > {tol} x {scale:.3e}"


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def rays(n, seed, spread=1.0):
    """Camera-like rays from z = -2 towards +z, in the renderer's (1, n, 3)."""
    rng = np.random.default_rng(seed)
    o = np.zeros((1, n, 3), np.float32)
    o[..., 2] = -2.0
    o[..., :2] = rng.uniform(-0.3, 0.3, (1, n, 2))
    d = rng.normal(size=(1, n, 3)).astype(np.float32) * spread
    d[..., 2] = np.abs(d[..., 2]) + 1.0
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_project_onto_planes_matches_the_inverse_plane_matrices():
    """The port selects two axes per plane; it equals coordinates @
    inv(plane) (and JAX's einsum) exactly."""
    coords = np.random.default_rng(0).uniform(-50, 50, (2, 37, 3)).astype(np.float32)
    inv = np.linalg.inv(T.generate_planes().astype(np.float64))
    want = np.einsum("nmc,pcd->npmd", coords.astype(np.float64), inv)[..., :2]
    got = T.project_onto_planes(t(coords)).numpy()
    np.testing.assert_array_equal(got, want.reshape(6, 37, 2).astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(J.project_onto_planes(jnp.asarray(coords))))
    np.testing.assert_array_equal(T.generate_planes(), J.generate_planes())


def test_ray_limits_box_matches_jax():
    rng = np.random.default_rng(1)
    o = rng.uniform(-6, 6, (1, 64, 3)).astype(np.float32)
    d = rng.normal(size=(1, 64, 3)).astype(np.float32)
    d[0, :4] = [[0, 0, 1], [0, 1, 0], [1, 0, 0], [0.6, 0.8, 0]]   # axis-aligned rays
    for got, want in zip(T.get_ray_limits_box(t(o), t(d), 4.0), jax.jit(
            J.get_ray_limits_box, static_argnums=2)(jnp.asarray(o), jnp.asarray(d), 4.0)):
        close(got, want, GEOM_TOL, scale=max(1.0, float(np.abs(np.asarray(want)).max())))
    tmin, _ = T.get_ray_limits_box(t(o), t(d), 4.0)
    assert (tmin == -1).any() and (tmin > 0).any()   # rays that miss and rays that hit


def test_batched_linspace_matches_jax():
    rng = np.random.default_rng(2)
    start = rng.uniform(0, 1, (1, 5, 1)).astype(np.float32)
    stop = start + rng.uniform(1, 3, (1, 5, 1)).astype(np.float32)
    close(T.batched_linspace(t(start), t(stop), 7),
          J.batched_linspace(jnp.asarray(start), jnp.asarray(stop), 7), GEOM_TOL)


def test_grid_sample_2d_matches_jax_and_f_grid_sample():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 8, 5, 7)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (3, 40, 2)).astype(np.float32)   # in band and beyond
    got = TG.grid_sample_2d(t(feats), t(coords))
    close(got, jax.jit(JG.grid_sample_2d)(jnp.asarray(feats), jnp.asarray(coords)), SAMPLE_TOL)
    lib = F.grid_sample(t(feats), t(coords)[:, None], mode="bilinear", padding_mode="zeros",
                        align_corners=False)[:, :, 0].permute(0, 2, 1)
    close(got, lib.numpy(), SAMPLE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grid_sample_2d_packed_matches_jax(dtype):
    """On an f32 table it equals the unpacked sampler bit for bit (as in
    JAX); on either table it equals JAX's packed sampler within SAMPLE_TOL."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((3, 8, 5, 7)).astype(np.float32)
    coords = np.concatenate([rng.uniform(-1.3, 1.3, (3, 40, 2)),
                             rng.uniform(-4.0, 4.0, (3, 24, 2)),
                             np.broadcast_to([[[-1.0, 1.0]]], (3, 1, 2)),
                             np.broadcast_to([[[1.0, -1.0]]], (3, 1, 2))],
                            axis=1).astype(np.float32)
    table = TG.pack_grid_for_block_sample(t(feats), dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jtable = JG.pack_grid_for_block_sample(jnp.asarray(feats), jdtype)
    np.testing.assert_array_equal(table.float().numpy(), np.asarray(jtable, np.float32))
    got = TG.grid_sample_2d_packed(table, t(coords))
    close(got, jax.jit(JG.grid_sample_2d_packed)(jtable, jnp.asarray(coords)), SAMPLE_TOL)
    if dtype == torch.float32:
        assert torch.equal(got, TG.grid_sample_2d(t(feats), t(coords)))


def test_sample_from_planes_and_packed_match_jax():
    rng = np.random.default_rng(5)
    planes = rng.standard_normal((1, 3, 8, 16, 16)).astype(np.float32)
    coords = rng.uniform(-2.2, 2.2, (1, 300, 3)).astype(np.float32)
    got = T.sample_from_planes(t(planes), t(coords), 4.0)
    close(got, jax.jit(J.sample_from_planes, static_argnums=2)(
        jnp.asarray(planes), jnp.asarray(coords), 4.0), SAMPLE_TOL)
    packed = T.pack_planes_for_sampling(t(planes), torch.float32)
    assert packed.shape == (1, 3, 18, 18, 8)
    assert torch.equal(T.sample_from_packed_planes(packed, t(coords), 4.0), got)


@pytest.mark.parametrize("white_back", [False, True])
def test_mip_ray_march_matches_jax(white_back):
    rng = np.random.default_rng(6)
    depths = np.sort(rng.uniform(1, 5, (1, 7, 12, 1)), axis=2).astype(np.float32)
    colors = rng.uniform(0, 1, (1, 7, 12, 3)).astype(np.float32)
    dens = (rng.standard_normal((1, 7, 12, 1)) * 3).astype(np.float32)
    dens[0, 0] = -30.0   # a ray with no weight: depth nan -> inf -> clipped
    for got, want in zip(T.mip_ray_march(t(colors), t(dens), t(depths), white_back),
                         jax.jit(J.mip_ray_march, static_argnums=3)(
                             jnp.asarray(colors), jnp.asarray(dens), jnp.asarray(depths),
                             white_back)):
        close(got, want, STEP_TOL)


def test_sample_stratified_matches_jax():
    o, d = rays(5, 7)
    stratified = jax.jit(J.sample_stratified, static_argnums=(3, 4))
    for disparity in (False, True):
        close(T.sample_stratified(t(o), 0.5, 4.0, 9, disparity),
              stratified(jnp.asarray(o), 0.5, 4.0, 9, disparity), STEP_TOL)
    start, end = jax.jit(J.get_ray_limits_box, static_argnums=2)(
        jnp.asarray(o), jnp.asarray(d), 4.0)
    close(T.sample_stratified(t(o), t(start), t(end), 9),
          stratified(jnp.asarray(o), start, end, 9, False), STEP_TOL)


def test_sample_importance_and_unify_match_jax():
    rng = np.random.default_rng(8)
    z = np.sort(rng.uniform(0.5, 4.0, (1, 6, 12, 1)), axis=2).astype(np.float32)
    w = rng.uniform(0, 1, (1, 6, 11, 1)).astype(np.float32)
    got = T.sample_importance(t(z), t(w), 8)
    want = jax.jit(J.sample_importance, static_argnums=2)(jnp.asarray(z), jnp.asarray(w), 8)
    close(got, want, STEP_TOL)
    c1, c2 = rng.uniform(0, 1, (1, 6, 12, 3)), rng.uniform(0, 1, (1, 6, 8, 3))
    s1, s2 = rng.normal(size=(1, 6, 12, 1)), rng.normal(size=(1, 6, 8, 1))
    z2 = np.asarray(want).copy()
    z2[0, 0, 0, 0] = z[0, 0, 3, 0]   # a depth tie: the stable sort keeps coarse first
    args = [a.astype(np.float32) for a in (z, c1, s1, z2, c2, s2)]
    for a, b in zip(T.unify_samples(*map(t, args)),
                    jax.jit(J.unify_samples)(*map(jnp.asarray, args))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def tiny():
    cfg = J.TriPlaneConfig(**TINY, rendering=J.RenderingOptions(**OPTS))
    params = numpy_eg3d_tree(cfg, seed=3)
    model = T.EG3DRenderer(T.TriPlaneConfig(**TINY, rendering=T.RenderingOptions(**OPTS)))
    model.load_state_dict(eg3d_from_jax(params))
    planes = np.asarray(jax.jit(lambda p: J.triplane_planes(
        p, cfg, J.triplane_mapping(p, cfg, p["z"])))(params))
    return cfg, params, model, planes


def test_osg_decoder_matches_jax(tiny):
    _, params, model, _ = tiny
    feats = np.random.default_rng(9).standard_normal((1, 3, 50, 8)).astype(np.float32)
    want = J.apply_osg_decoder(params["decoder"], jnp.asarray(feats))
    got = model.decoder(t(feats))
    for k in ("rgb", "sigma"):
        close(got[k], want[k], STEP_TOL)


@pytest.mark.parametrize("mode", ["planes", "f32_table", "auto_box"])
def test_importance_render_matches_jax(tiny, mode):
    """The coarse + fine render on JAX's own planes: as (N, 3, C, H, W)
    planes, as an f32 sampling table, and with ray_start='auto'."""
    cfg, params, model, planes = tiny
    opts = dict(OPTS, ray_start="auto", ray_end="auto") if mode == "auto_box" else OPTS
    o, d = rays(33, 10)
    packed = mode == "f32_table"
    tp = T.pack_planes_for_sampling(t(planes), torch.float32) if packed else t(planes)
    jp = J.pack_planes_for_sampling(jnp.asarray(planes), jnp.float32) if packed else planes
    with torch.no_grad():
        got = T.importance_render(tp, model.decoder, t(o), t(d), T.RenderingOptions(**opts),
                                  packed=packed)
    want = jax.jit(lambda p, dec, o, d: J.importance_render(
        p, dec, o, d, J.RenderingOptions(**opts), packed=packed))(
        jp, params["decoder"], jnp.asarray(o), jnp.asarray(d))
    for a, b in zip(got, want):
        close(a, b, RENDER_TOL)
    assert float(got[5].mean()) > 0.05   # the fine pass sees density


def test_eg3d_render_and_sample_match_jax(tiny):
    """eg3d_render (mapping + synthesis + render, float32 planes) and
    eg3d_sample, end to end from the same weights."""
    cfg, params, model, _ = tiny
    o, d = rays(20, 11)
    with torch.no_grad():
        got = T.eg3d_render(model, t(o[0]), t(d[0]))
        pts = np.random.default_rng(12).uniform(-2, 2, (40, 3)).astype(np.float32)
        got_s = T.eg3d_sample(model, t(pts))
    want = jax.jit(lambda p, o, d: J.eg3d_render(p, cfg, o, d))(
        params, jnp.asarray(o[0]), jnp.asarray(d[0]))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], RENDER_TOL)
    want_s = jax.jit(lambda p, x: J.eg3d_sample(p, cfg, x))(params, jnp.asarray(pts))
    for k in ("rgb", "sigma"):
        close(got_s[k], want_s[k], RENDER_TOL)
