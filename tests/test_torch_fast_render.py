"""The port's fast renderer (`render/fast.py`) against the JAX package's on
the CPU: the scene box, the proxy distillation, `render_rays_fast` on its
plain route for every selection / placement / quadrature option and on its
kernel route (K3's plain version, the field's plain version) against JAX's
Pallas kernels in interpret mode.

The JAX kernel route pads rays to the proxy kernel's ray tile; here
`proxy_march.TILE_R` is shrunk to 256 (as tests/test_fused_mlp.py shrinks
the field's tile) so R = 512 rays are two tiles, and the JAX `cull` and
`adaptive` fractions, which round up to whole tiles, land on the port's
exact fractions. Half of those rays are degenerate ([near, far] of width
1e-6, so proxy and field see nothing): the opacity and ambiguity rankings
then pick the same rays on both sides, whatever the last bits.

Tolerances. `estimate_scene_aabb`: exact. Renders: per output, median |d|
< 2e-3 and 99th percentile < 0.05 of the output's scale max(1, max |ref|)
(tests/test_proxy_march.py's bars): bf16 operands with float32 sums in
another order move the proxy's scores, and with them the CDF and the
survivor depths, by O(eps), and a top-K ranking can swap near-equal
candidates. The kernel route's `ratio` quadrature takes the landing bin's
proxy density, which jumps where a depth crosses a bin edge, so it is held
to tests/test_proxy_march.py's ratio bars: median < 5e-3 and 95% within
0.05. With f32 compute (`compute_dtype=None`) the plain topk route is held
to atol 1e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.render import fast as jfast
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp as k1
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.render import fast
from tests.test_torch_proxy_march import port_proxy, rays_np
from tests.test_torch_rendering import with_density
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

SMALL = NeRFConfig(depth=5, width=128)


@pytest.fixture(scope="module", autouse=True)
def small_tiles():
    old = jfm.TILE_N, jpm.TILE_R
    jfm.TILE_N, jpm.TILE_R = 128, 256   # keep interpreter-mode runs fast
    yield
    jfm.TILE_N, jpm.TILE_R = old


@pytest.fixture(scope="module")
def scene():
    params = with_density(init_nerf(jax.random.PRNGKey(0), SMALL))
    model = NeRF(SMALL)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    tree = jfast.init_proxy(jax.random.PRNGKey(3), hidden=96)
    return {"params": {"fine": params}, "models": {"fine": model}, "tree": tree,
            "proxy": port_proxy(tree)}


def close(got, want, what="", ratio=False):
    for k, v in want.items():
        ref = np.asarray(v)
        g = got[k].detach().numpy()
        assert g.shape == ref.shape, (what, k)
        err = np.abs(g - ref) / max(1.0, float(np.abs(ref).max()))
        if ratio:
            assert np.median(err) < 5e-3 and np.mean(err < 0.05) > 0.95, (what, k)
        else:
            assert np.median(err) < 2e-3 and np.percentile(err, 99) < 0.05, (what, k)


def half_degenerate(n, seed):
    rays = rays_np(n, seed)
    rays[::2, 7] = rays[::2, 6] + 1e-6
    return rays


# ---- geometry ----------------------------------------------------------------

def test_estimate_scene_aabb_equals_jax():
    def ball_j(p):
        return jnp.where(jnp.sum((p - jnp.asarray([0.3, -0.2, 0.1])) ** 2, -1) < 0.36, 50.0, 0.0)

    def ball_t(p):
        return torch.where(((p - torch.tensor([0.3, -0.2, 0.1])) ** 2).sum(-1) < 0.36, 50.0, 0.0)

    for lo, hi in (([-2.0] * 3, [2.0] * 3), ([-3.0, -1.0, -2.0], [1.0, 2.0, 3.0])):
        want = jfast.estimate_scene_aabb(ball_j, lo, hi, resolution=48)
        got = fast.estimate_scene_aabb(ball_t, lo, hi, resolution=48, chunk=10_000)
        for a, b in zip(got, want):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    # nothing above the threshold: the search box itself
    lo, hi = fast.estimate_scene_aabb(lambda p: torch.zeros(p.shape[0]), [-1] * 3, [1] * 3)
    np.testing.assert_array_equal(lo, [-1] * 3)
    np.testing.assert_array_equal(hi, [1] * 3)


def test_distill_proxy_learns_the_ball_and_suppresses_phantoms():
    """tests/test_fast_render.py's check on the port (the RNG streams differ
    from JAX's, so it is statistical): the asymmetric loss cuts the proxy's
    99th-percentile score in empty space below the symmetric loss's, and
    the occupied region keeps its signal (log1p(50) ~ 3.9)."""
    def sigma_fn(pts):
        return torch.where((pts ** 2).sum(-1) < 0.25, 50.0, 0.0)

    kw = dict(steps=150, batch=4096, hidden=32)
    p_sym = fast.distill_proxy(sigma_fn, [-2] * 3, [2] * 3, torch.Generator().manual_seed(0),
                               overpredict_weight=1.0, **kw)
    p_asym = fast.distill_proxy(sigma_fn, [-2] * 3, [2] * 3, torch.Generator().manual_seed(0),
                                **kw)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (8192, 3)).astype(np.float32)
    empty = torch.from_numpy(pts[np.sum(pts ** 2, -1) > 0.5])
    with torch.no_grad():
        phantom_sym = float(torch.quantile(fast.apply_proxy(p_sym, empty, None), 0.99))
        phantom_asym = float(torch.quantile(fast.apply_proxy(p_asym, empty, None), 0.99))
        inside = torch.from_numpy(rng.uniform(-0.3, 0.3, (512, 3)).astype(np.float32))
        score_in = float(fast.apply_proxy(p_asym, inside, None).mean())
    assert phantom_asym < phantom_sym
    assert score_in > 1.0 and score_in > 3 * phantom_asym


def test_distill_proxy_loss_falls():
    """The distillation objective falls over its steps (same generator: the
    longer run continues the shorter one's stream)."""
    def sigma_fn(pts):
        return torch.where((pts ** 2).sum(-1) < 0.25, 50.0, 0.0)

    pts = torch.from_numpy(np.random.default_rng(1).uniform(-2, 2, (8192, 3)).astype(np.float32))
    target = torch.log1p(torch.relu(sigma_fn(pts)))

    def loss(steps):
        p = fast.distill_proxy(sigma_fn, [-2] * 3, [2] * 3, torch.Generator().manual_seed(1),
                               steps=steps, batch=2048, hidden=32)
        with torch.no_grad():
            err = fast.apply_proxy(p, pts, None) - target
            return float(((1 + target) * err ** 2 * torch.where(err > 0, 16.0, 1.0)).mean())

    l0, l1, l2 = loss(0), loss(20), loss(120)
    assert l2 < l1 < l0


# ---- render_rays_fast, plain route ---------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(select="topk"),
    dict(select="topk", refine_mult=2),
    dict(select="topk", scene_aabb=([-1.0] * 3, [1.0] * 3)),
    dict(select="pdf", placement="mid"),
    dict(select="pdf", placement="edges", scene_aabb=([-1.0, -1.5, -1.0], [1.0, 1.5, 1.2])),
    dict(select="pdf", placement="mid", quadrature="ratio"),
    dict(select="pdf", return_samples=True),
], ids=["topk", "topk-refine2", "topk-aabb", "pdf-mid", "pdf-edges-aabb", "pdf-ratio",
        "pdf-samples"])
def test_plain_route_matches_jax(scene, kw):
    rays = rays_np(256, seed=1)
    common = dict(n_candidates=32, n_keep=8, white_back=True, **kw)
    want = jfast.render_rays_fast(scene["params"], scene["tree"], jnp.asarray(rays),
                                  nerf_cfg=SMALL, **common)
    with torch.no_grad():
        got = fast.render_rays_fast(scene["models"], scene["proxy"], torch.from_numpy(rays),
                                    **common)
    assert set(got) == set(want)
    close(got, want, kw)


def test_plain_topk_route_matches_jax_at_f32(scene):
    rays = rays_np(256, seed=2)
    common = dict(n_candidates=32, n_keep=8, select="topk", compute_dtype=None)
    want = jfast.render_rays_fast(scene["params"], scene["tree"], jnp.asarray(rays),
                                  nerf_cfg=SMALL, **common)
    with torch.no_grad():
        got = fast.render_rays_fast(scene["models"], scene["proxy"], torch.from_numpy(rays),
                                    **common)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=1e-4, rtol=0,
                                   err_msg=k)


def test_plain_route_runs_the_field_pack(scene):
    """With a field pack the plain route evaluates the survivors with the
    field kernel's wrapper (its plain version here) instead of the module:
    the same render within the bf16 bars."""
    rays = torch.from_numpy(rays_np(128, seed=3))
    kw = dict(n_candidates=32, n_keep=8, select="topk", white_back=True)
    with torch.no_grad():
        a = fast.render_rays_fast(scene["models"], scene["proxy"], rays, **kw)
        b = fast.render_rays_fast(None, scene["proxy"], rays,
                                  packed_params=k1.pack_model_params(scene["models"]), **kw)
    close(b, a)


def test_ratio_needs_pdf_mid(scene):
    with pytest.raises(ValueError, match="ratio"):
        fast.render_rays_fast(scene["models"], scene["proxy"], torch.zeros(4, 8),
                              select="topk", quadrature="ratio")


# ---- render_rays_fast, kernel route (K3 + the field at the survivors) -----------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(placement="edges", scene_aabb=([-1.0] * 3, [1.0] * 3)),
    dict(quadrature="ratio"),
    dict(cull=0.5),
    dict(adaptive=(0.5, 16)),
    dict(return_samples=True),
], ids=["delta-mid", "edges-aabb", "ratio", "cull", "adaptive", "samples"])
def test_kernel_route_matches_jax(scene, kw):
    rays = half_degenerate(2 * jpm.TILE_R, seed=4)
    common = dict(n_candidates=16, n_keep=8, white_back=True, select="pdf", **kw)
    want = jfast.render_rays_fast(
        scene["params"], scene["tree"], jnp.asarray(rays), nerf_cfg=SMALL,
        packed_params=jfm.pack_model_params(scene["params"], SMALL),
        packed_proxy=jpm.pack_proxy_params(scene["tree"]), **common)
    with torch.no_grad():
        got = fast.render_rays_fast(None, scene["proxy"], torch.from_numpy(rays),
                                    packed_params=k1.pack_model_params(scene["models"]),
                                    packed_proxy=k3.pack_proxy_params(scene["proxy"]), **common)
    assert set(got) == set(want)
    close(got, want, kw, ratio="quadrature" in kw)
    if "cull" in kw:   # half the rays render, the rest composite to background
        opac, rgb = got["opacity_fine"].numpy(), got["rgb_fine"].numpy()
        assert ((opac == 0) & (rgb == 1).all(-1)).sum() >= rays.shape[0] // 2
        assert (opac[::2] < 1e-5).all()


def test_kernel_route_full_fractions_equal_the_plain_frame(scene):
    """cull=1 renders every ray and adaptive=(1, k_hi) re-renders every ray
    at k_hi: both equal the kernel route's plain frame (at n_keep, and at
    k_hi), exactly on the CPU (the same plain versions on the same rays)."""
    rays = torch.from_numpy(rays_np(300, seed=5))
    pp, pf = k3.pack_proxy_params(scene["proxy"]), k1.pack_model_params(scene["models"])
    kw = dict(n_candidates=16, white_back=True, select="pdf", packed_params=pf,
              packed_proxy=pp)
    with torch.no_grad():
        base = fast.render_rays_fast(None, None, rays, n_keep=8, **kw)
        hi = fast.render_rays_fast(None, None, rays, n_keep=12, **kw)
        culled = fast.render_rays_fast(None, None, rays, n_keep=8, cull=1.0, **kw)
        adapt = fast.render_rays_fast(None, None, rays, n_keep=8, adaptive=(1.0, 12), **kw)
    for k in base:
        torch.testing.assert_close(culled[k], base[k], atol=1e-6, rtol=0)
        torch.testing.assert_close(adapt[k], hi[k], atol=1e-6, rtol=0)


# ---- whole-frame drivers -------------------------------------------------------

def _cull_frame(fg_blocks, seed, block=64, n_blocks=16):
    """n_blocks x block rays; the blocks in `fg_blocks` are real rays, the
    rest degenerate ([near, far] of width 1e-6: empty to proxy and field)."""
    rays = rays_np(block * n_blocks, seed)
    for b in range(n_blocks):
        if b not in fg_blocks:
            rays[b * block:(b + 1) * block, 7] = rays[b * block:(b + 1) * block, 6] + 1e-6
    return rays


def test_auto_cull_renderer_matches_jax_over_a_frame_sequence(scene, monkeypatch):
    """`make_auto_cull_renderer` against JAX's over sparse -> dense -> sparse
    frames: every frame's outputs (the render bars above), and exactly its
    `last_active_frac` and `last_plain`; `last_eps` within 1e-5 relative.

    The budget quantum is two blocks of 64 rays here: both sides take a
    128-ray tile (`TILE_R`, the port's quantum and JAX's kernel tile). The
    proxy's output layer is scaled down and biased up so every real ray has
    a clear proxy opacity, and the block ranking is not decided by ties."""
    monkeypatch.setattr(jpm, "TILE_R", 128)
    monkeypatch.setattr(fast, "TILE_R", 128)
    tree = jax.tree_util.tree_map(np.asarray, scene["tree"])
    tree = {"l1": tree["l1"], "l2": {"kernel": tree["l2"]["kernel"] * 0.3,
                                     "bias": tree["l2"]["bias"] + 1.0}}
    proxy = port_proxy(tree)
    kw = dict(n_candidates=8, n_keep=4, white_back=True, block=64)
    want_r = jfast.make_auto_cull_renderer(
        scene["params"], tree, nerf_cfg=SMALL,
        packed_params=jfm.pack_model_params(scene["params"], SMALL),
        packed_proxy=jpm.pack_proxy_params(tree), **kw)
    got_r = fast.make_auto_cull_renderer(
        None, proxy, packed_params=k1.pack_model_params(scene["models"]),
        packed_proxy=k3.pack_proxy_params(proxy), **kw)
    sparse, dense = (2, 9), tuple(b for b in range(16) if b not in (0, 15))
    frames = [sparse, sparse, dense, dense, dense, sparse, sparse, sparse]
    trace = []
    for i, fg in enumerate(frames):
        rays = _cull_frame(fg, seed=10 + i)
        want = want_r(jnp.asarray(rays))
        with torch.no_grad():
            got = got_r(torch.from_numpy(rays))
        close(got, want, f"frame {i}")
        assert got_r.last_active_frac == want_r.last_active_frac, i
        assert got_r.last_plain == want_r.last_plain, i
        np.testing.assert_allclose(float(got_r.last_eps), float(np.asarray(want_r.last_eps)[0]),
                                   rtol=1e-5, err_msg=str(i))
        trace.append((got_r.last_active_frac, got_r.last_plain))
    # the sequence runs a full first frame, culled frames and the bypass
    assert trace[0] == (1.0, False)
    assert any(f < 1.0 and not p for f, p in trace) and any(p for _, p in trace), trace


def test_edge_refined_renderer_matches_jax(scene):
    """`make_edge_refined_renderer` over one base frame handed to both sides:
    the same edge rays refined (`last_refined` exactly) and the outputs
    within the render bars (the refinement's fused render is K1's plain
    version here, JAX's Pallas K1 in interpret mode there)."""
    h = w = 16
    rays = rays_np(h * w, seed=21)
    common = dict(n_candidates=16, n_keep=8, white_back=True, select="topk")
    base = {k: np.asarray(v) for k, v in jfast.render_rays_fast(
        scene["params"], scene["tree"], jnp.asarray(rays), nerf_cfg=SMALL, **common).items()}
    params = {"coarse": scene["params"]["fine"], "fine": scene["params"]["fine"]}
    models = {"coarse": scene["models"]["fine"], "fine": scene["models"]["fine"]}
    kw = dict(white_back=True, n_samples=16, n_importance=8, cap_frac=0.2, chunk=32)
    want_r = jfast.make_edge_refined_renderer(
        lambda r: {k: jnp.asarray(v) for k, v in base.items()},
        jfm.pack_model_params(params, SMALL), (h, w), nerf_cfg=SMALL, **kw)
    got_r = fast.make_edge_refined_renderer(
        lambda r: {k: torch.from_numpy(v.copy()) for k, v in base.items()},
        k1.pack_model_params(models), (h, w), **kw)
    want = want_r(jnp.asarray(rays))
    with torch.no_grad():
        got = got_r(torch.from_numpy(rays))
    assert got_r.n_edge == want_r.n_edge == 64
    assert int(got_r.last_refined) == int(want_r.last_refined) > 0
    close(got, want)
    changed = np.abs(got["rgb_fine"].numpy() - base["rgb_fine"]).max(-1) > 0
    assert changed.sum() <= int(got_r.last_refined)
