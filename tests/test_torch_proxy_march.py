"""The port's density proxy and the plain versions of its proxy kernels
against the JAX package: `apply_proxy`, the proxy weights' round trip
through `convert.py`, the proxy march (K3: `proxy_opacity`,
`proxy_march_select` with its density aux) and the proxy top-K (K6:
`proxy_select`, down to one candidate); and, torch only, K3's pack
(`k3_w1t`: its column permutation against its plain inverse), the plain
march on given scores, and the plain top-K on given scores against a
numpy transcription of the JAX kernel's rounds and against the kernel's
rank rule (`rank_select_ref`). The JAX kernels run in Pallas interpret mode on the CPU, as
tests/test_proxy_march.py and tests/test_fast_render.py run them: K3 on
R = TILE_R = 2048 rays.

Tolerances (the JAX kernel tests' own bars, which their kernels meet
against the jnp pipeline): the TPU kernel sums the proxy's first layer as
W1x.o + (W1x.d) z in bf16 matmul order, the port in input order, so scores
differ by float32 rounding and the CDF moves by O(eps). Opacity: median
|d| < 2e-3, max < 0.05. Depths: median |d| < 0.005 and 99th percentile
< 0.05 of far - near. Density aux: relative median < 0.05 and 80% within
0.25 (a sample that crosses a bin edge takes its neighbour's density);
mass relative median < 0.05. K6: per-ray set equality of the depths,
atol 1e-5. `apply_proxy`: f32 atol 1e-5; bf16 atol 2e-3 (bf16 operands,
float32 sums in another order, the hidden layer rounded to bf16).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.ops.pallas import proxy_select as jps
from nerf_siren_tpu.render import fast as jfast
from nerf_siren_tpu_torch.convert import proxy_from_jax, proxy_to_jax
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.ops.kernels import proxy_select as k6
from nerf_siren_tpu_torch.render.fast import Proxy, apply_proxy
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

C, K = 16, 8
SPAN = 4.0   # far - near


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_proxy(tree) -> Proxy:
    state = proxy_from_jax(_numpy(tree))
    proxy = Proxy(state["l1.weight"].shape[0])
    proxy.load_state_dict(state)
    return proxy


def rays_np(n, seed=0):
    """tests/test_proxy_march.py's rays: origins in a 0.4 cube, unit
    directions, near 2, far 6."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((n, 1), 2.0, np.float32),
                           np.full((n, 1), 6.0, np.float32)], -1)


@pytest.fixture(scope="module")
def proxy():
    tree = jfast.init_proxy(jax.random.PRNGKey(3), hidden=96)
    return tree, jpm.pack_proxy_params(tree), k3.pack_proxy_params(port_proxy(tree))


def test_proxy_round_trip_is_bit_exact():
    tree = _numpy(jfast.init_proxy(jax.random.PRNGKey(5), hidden=48))
    back = proxy_to_jax(port_proxy(tree).state_dict())
    assert set(back) == {"l1", "l2"}
    for layer in ("l1", "l2"):
        for k in ("kernel", "bias"):
            assert back[layer][k].dtype == np.float32
            np.testing.assert_array_equal(back[layer][k], tree[layer][k])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_apply_proxy_matches_jax(proxy, dtype):
    tree = proxy[0]
    pts = np.random.default_rng(1).uniform(-3, 3, (4096, 3)).astype(np.float32)
    want = np.asarray(jfast.apply_proxy(tree, jnp.asarray(pts),
                                        jnp.bfloat16 if dtype == "bfloat16" else None))
    got = apply_proxy(port_proxy(tree), torch.from_numpy(pts),
                      torch.bfloat16 if dtype == "bfloat16" else None).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-3 if dtype == "bfloat16" else 1e-5, rtol=0)


def test_kernel_order_score_matches_apply_proxy(proxy):
    """The plain score in the kernels' summation order is `apply_proxy` at
    bf16 up to that order (atol 2e-3, the bf16 bar above)."""
    pts = torch.from_numpy(np.random.default_rng(2).uniform(-3, 3, (2048, 3)).astype(np.float32))
    np.testing.assert_allclose(k3.proxy_scores_ref(proxy[2], pts).numpy(),
                               apply_proxy(port_proxy(proxy[0]), pts).detach().numpy(),
                               atol=2e-3, rtol=0)


def test_proxy_opacity_matches_jax(proxy):
    _, jpack, tpack = proxy
    rays = rays_np(jpm.TILE_R, seed=4)
    want = np.asarray(jpm.proxy_opacity(jpack, jnp.asarray(rays).T, C))
    got = k3.proxy_opacity(tpack, torch.from_numpy(rays), C).numpy()
    err = np.abs(got - want)
    assert np.median(err) < 2e-3 and err.max() < 0.05


@pytest.mark.parametrize("midpoint", [False, True])
def test_march_select_matches_jax(proxy, midpoint):
    _, jpack, tpack = proxy
    rays = rays_np(jpm.TILE_R, seed=0)
    z_j, xyz_j, dir_j = jpm.proxy_march_select(jpack, jnp.asarray(rays).T, C, K,
                                               midpoint=midpoint)
    z_j = np.asarray(z_j).T                                          # (R, K)
    z, xyz = k3.proxy_march_select(tpack, torch.from_numpy(rays), C, K, midpoint)
    z, xyz = z.numpy(), xyz.numpy()
    err = np.abs(z - z_j)
    assert np.median(err) < 0.005 * SPAN and np.percentile(err, 99) < 0.05 * SPAN
    assert np.all(np.diff(z, axis=-1) >= -1e-5)
    # survivors ray-major (R, K, 3) where JAX lays them out candidate-major
    np.testing.assert_allclose(xyz, rays[:, None, :3] + rays[:, None, 3:6] * z[..., None],
                               atol=1e-5, rtol=0)
    xyz_j = np.asarray(xyz_j)[:3].reshape(3, K, -1).transpose(2, 1, 0)
    np.testing.assert_allclose(xyz_j, rays[:, None, :3] + rays[:, None, 3:6] * z_j[..., None],
                               atol=1e-4, rtol=0)


def test_march_density_aux_matches_jax(proxy):
    _, jpack, tpack = proxy
    rays = rays_np(jpm.TILE_R, seed=8)
    out = jpm.proxy_march_select(jpack, jnp.asarray(rays).T, C, K, midpoint=True,
                                 return_density=True)
    aux = np.asarray(out[3])
    rho_j, mass_j = aux[:K].T, aux[K]
    z, xyz, rho, mass = (t.numpy() for t in k3.proxy_march_select(
        tpack, torch.from_numpy(rays), C, K, True, True))
    rel_w = np.abs(mass - mass_j) / np.maximum(mass_j, 1e-4)
    assert np.median(rel_w) < 0.05
    rel = np.abs(rho - rho_j) / np.maximum(np.abs(rho_j), 1e-3)
    assert np.median(rel) < 0.05 and np.mean(rel < 0.25) > 0.8


def _jnp_march(tree, rays, c):
    """JAX's jnp march, the function K3 stands in for (render_rays_fast's
    pdf selection): the proxy's bf16 scores at C uniform candidates, their
    alphas and transmittance; (z, w_hat, final transmittance)."""
    jr = jnp.asarray(rays)
    near, far = jr[:, 6:7], jr[:, 7:8]
    t = jnp.linspace(0.0, 1.0, c)
    z = near * (1 - t) + far * t
    score = jfast.apply_proxy(tree, jr[:, None, 0:3] + jr[:, None, 3:6] * z[..., None],
                              jnp.bfloat16)
    a_hat = 1.0 - jnp.exp(-jnp.expm1(jax.nn.relu(score)) * (far - near) / (c - 1))
    tr = jnp.cumprod(1.0 - a_hat + 1e-10, axis=-1)
    w_hat = a_hat * jnp.concatenate([jnp.ones_like(tr[:, :1]), tr[:, :-1]], -1)
    return z, w_hat, tr[:, -1]


def test_march_and_opacity_at_512_candidates_match_jax(proxy):
    """Above the 256 candidates the card once took: K3's plain versions at C
    512 against JAX's jnp march (the Pallas march unrolls its candidate loop
    when it traces, which at C 512 takes minutes and gigabytes in interpret
    mode on the CPU), at the bars above."""
    from nerf_siren_tpu.ops.sample_pdf import sample_pdf

    tree, _, tpack = proxy
    c, rays = 512, rays_np(64, seed=9)
    z, w_hat, trans = _jnp_march(tree, rays, c)
    got = k3.proxy_opacity(tpack, torch.from_numpy(rays), c).numpy()
    err = np.abs(got - (1.0 - np.asarray(trans)))
    assert np.median(err) < 2e-3 and err.max() < 0.05
    z_ref = np.asarray(sample_pdf(0.5 * (z[:, :-1] + z[:, 1:]), w_hat[:, 1:-1], K, rng=None,
                                  det=True, midpoint=True))
    got = k3.proxy_march_select(tpack, torch.from_numpy(rays), c, K, True)[0].numpy()
    err = np.abs(got - z_ref)
    assert np.median(err) < 0.005 * SPAN and np.percentile(err, 99) < 0.05 * SPAN


def test_march_plain_matches_the_jnp_pdf_path(proxy):
    """The plain march against render_rays_fast's jnp pdf selection (the
    JAX function K3 stands in for), at the same bars."""
    from nerf_siren_tpu.ops.sample_pdf import sample_pdf

    tree, _, tpack = proxy
    rays = rays_np(512, seed=1)
    z, w_hat, _ = _jnp_march(tree, rays, C)
    z_ref = np.asarray(sample_pdf(0.5 * (z[:, :-1] + z[:, 1:]), w_hat[:, 1:-1], K, rng=None,
                                  det=True, midpoint=True))
    got = k3.proxy_march_select(tpack, torch.from_numpy(rays), C, K, True)[0].numpy()
    err = np.abs(got - z_ref)
    assert np.median(err) < 0.005 * SPAN and np.percentile(err, 99) < 0.05 * SPAN


@pytest.mark.parametrize("hidden", [1, 48, 96, 100, 128])
def test_k3_w1t_pack_and_its_plain_inverse(hidden):
    """K3's W1^T tile: the plain inverse gives w1 back; the tile is the
    permuted W1^T, zero in the padding columns and rows, in the 128-byte
    swizzle (16-byte chunk j of row n at chunk j ^ (n % 8))."""
    from nerf_siren_tpu_torch.render.fast import init_proxy

    pp = k3.pack_proxy_params(init_proxy(hidden, generator=torch.Generator().manual_seed(hidden)))
    tile = pp["k3_w1t"]
    width = k3.k3_width(hidden)
    assert width in k3.K3_WIDTHS and width >= hidden and tile.shape == (width, k3.K3_ROW)
    assert tile.dtype == torch.bfloat16 and tile.is_contiguous()
    assert torch.equal(k3.unpack_k3_w1t(tile, hidden), pp["w1"])
    dense = tile.view(width, 8, 8)[torch.arange(width)[:, None],
                                   torch.arange(8)[None, :] ^ (torch.arange(width) % 8)[:, None]]
    dense = dense.reshape(width, k3.K3_ROW)
    cols = k3.k3_columns()
    for c in range(k3.K3_ROW):
        want = (pp["w1"][:, cols[c]] if c < k3.K3_COLUMNS and cols[c] >= 0
                else torch.zeros(hidden, dtype=torch.bfloat16))
        assert torch.equal(dense[:hidden, c], want)
    assert not dense[hidden:].any()
    with pytest.raises(ValueError, match="k3_w1t"):
        k3.unpack_k3_w1t(tile[:, :32], hidden)


def test_k3_embedding_columns_each_held_by_one_thread_slot():
    """Each of the 33 reference embedding columns is placed by exactly one
    (thread of the quad, pair, half), at the A column wgmma's register
    fragment gives that slot; every other slot of the 48 columns is zero;
    and a thread places the sin and cos of an angle in one pair."""
    slots = {}
    for t in range(4):
        for i in range(6):
            for e in range(2):
                col = k3.k3_column(t, i, e)
                assert col not in slots.values() and 0 <= col < k3.K3_COLUMNS
                slots[(t, i, e)] = col
                ref = k3.k3_slot(t, i, e)
                assert k3.k3_columns()[col] == ref
    assert len(slots) == k3.K3_COLUMNS
    placed = [c for c in k3.k3_columns() if c >= 0]
    assert sorted(placed) == list(range(k3.PROXY_IN))
    for t in range(4):
        for i in range(4):
            sin, cos = k3.k3_slot(t, i, 0), k3.k3_slot(t, i, 1)
            if sin >= 3:
                assert cos == sin + 3 and (sin - 3) % 6 < 3
    # the embedding through the permuted columns gives the same pre-activations
    pp = k3.pack_proxy_params(port_proxy(jfast.init_proxy(jax.random.PRNGKey(2), hidden=96)))
    x = torch.from_numpy(np.random.default_rng(4).uniform(-4, 4, (300, 3)).astype(np.float32))
    emb = k3._pre_ref(pp, x)[0]
    cols = torch.tensor(k3.k3_columns())
    a = torch.where(cols >= 0, emb[:, cols.clamp_min(0)], torch.zeros(()))
    w1t = k3.unpack_k3_w1t(pp["k3_w1t"], 96)
    perm = torch.where(cols >= 0, w1t.float()[:, cols.clamp_min(0)], torch.zeros(()))
    np.testing.assert_allclose((a @ perm.t()).numpy(), (emb @ pp["w1"].float().t()).numpy(),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("c,midpoint", [(5, False), (16, True), (37, True)])
def test_plain_march_on_given_scores_equals_the_plain_march(proxy, c, midpoint):
    """The plain march given `proxy_march_scores_ref`'s scores equals the
    plain march that scores the candidates itself, bit for bit: opacity,
    depths, survivors, densities and mass."""
    tpack = proxy[2]
    rays = torch.from_numpy(rays_np(333, seed=6))
    scores = k3.proxy_march_scores_ref(tpack, rays, c)
    assert scores.shape == (333, c)
    assert torch.equal(scores, k3.proxy_scores_ref(tpack, k3.candidate_points(rays, c)))
    assert torch.equal(k3.proxy_opacity_ref(tpack, rays, c, scores=scores),
                       k3.proxy_opacity_ref(tpack, rays, c))
    for a, b in zip(k3.proxy_march_select_ref(tpack, rays, c, 8, midpoint, True, scores=scores),
                    k3.proxy_march_select_ref(tpack, rays, c, 8, midpoint, True)):
        assert torch.equal(a, b)
    assert torch.equal(k3.proxy_march_scores(tpack, rays, c), scores)   # CPU: the plain version
    bar = k3.proxy_score_bar(tpack, k3.candidate_points(rays, c))
    assert bar.shape == (333, c) and bool((bar > 0).all())


@pytest.mark.parametrize("hidden", [48, 96, 128])
def test_proxy_score_bar_holds_a_reordered_sum_and_rejects_b1_in_bf16(hidden):
    """`proxy_score_bar` holds the plain scores summed in another order (both
    products as matmuls) at every point, and rejects the scores with b1
    rounded to bf16 (as a kernel folding b1 into its bf16 product would give
    them) at many points."""
    from nerf_siren_tpu_torch.ops.kernels.fused_mlp import _bf16
    from nerf_siren_tpu_torch.render.fast import init_proxy

    pp = k3.pack_proxy_params(init_proxy(hidden, generator=torch.Generator().manual_seed(7)))
    x = torch.from_numpy(np.random.default_rng(8).uniform(-4, 4, (20000, 3)).astype(np.float32))
    ref, bar = k3.proxy_scores_ref(pp, x), k3.proxy_score_bar(pp, x)
    emb, _ = k3._pre_ref(pp, x)
    h = _bf16(torch.relu(emb @ pp["w1"].float().t() + pp["b1"]))
    reordered = h @ pp["w2"].float() + pp["b2"]
    folded = k3.proxy_scores_ref({**pp, "b1": _bf16(pp["b1"])}, x)

    def over(scores):
        d = (scores - ref).abs()
        return torch.where(d > 0, d / bar, torch.zeros(()))

    assert float(over(reordered).max()) <= 1.0
    assert float((over(folded) > 1.0).float().mean()) > 0.05


@pytest.mark.parametrize("n,nc,nk", [(70, 32, 8), (64, 64, 16), (5, 1, 1), (9, 2, 2),
                                     (9, 3, 2), (20, 512, 16)])
def test_proxy_select_matches_jax(n, nc, nk):
    """K6's plain version against the JAX kernel (tests/test_fast_render.py's
    rays): the same depths per ray, atol 1e-5; JAX's tie order may differ,
    so both are sorted. At one candidate both give near (linspace(0, 1, 1)
    is 0)."""
    tree = jfast.init_proxy(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.2, d,
                           np.full((n, 1), 2, np.float32), np.full((n, 1), 6, np.float32)], -1)
    want = np.sort(np.asarray(jps.proxy_select(jps.pack_proxy_params(tree),
                                               jnp.asarray(rays), nc, nk)), -1)
    packed = k6.pack_proxy_params(port_proxy(tree))
    got = k6.proxy_select(packed, torch.from_numpy(rays), nc, nk).numpy()
    np.testing.assert_allclose(np.sort(got, -1), want, atol=1e-5, rtol=0)
    # score order: every kept depth scores at least as high as the next
    z = torch.from_numpy(got)
    scores = k3.proxy_scores_ref(packed, torch.from_numpy(rays[:, None, :3])
                                 + torch.from_numpy(rays[:, None, 3:6]) * z[..., None])
    assert bool((scores[:, 1:] <= scores[:, :-1]).all())


def jax_rounds_np(scores, z, n_keep):
    """A numpy transcription of the JAX kernel's selection
    (nerf_siren_tpu/ops/pallas/proxy_select.py::_kernel): K rounds of the
    highest score, the lowest index among equals, its depth, and -inf in
    its place."""
    scores = scores.copy()
    lane = np.arange(scores.shape[1])[None, :]
    out = np.zeros((scores.shape[0], n_keep), np.float32)
    for kk in range(n_keep):
        m = scores.max(1, keepdims=True)
        idx = np.where(scores == m, lane, scores.shape[1]).min(1, keepdims=True)
        sel = lane == idx
        out[:, kk] = np.where(sel, z, 0.0).sum(1)
        scores = np.where(sel, -np.inf, scores)
    return out


def _tied_scores(rng, r, c):
    """Scores of a few values (many ties), with +0.0 and -0.0 (equal) among
    them."""
    s = rng.integers(-2, 3, (r, c)).astype(np.float32) * 0.5
    s[s == 0] = np.where(rng.random(int((s == 0).sum())) < 0.5, -0.0, 0.0)
    return s


@pytest.mark.parametrize("c,k", [(1, 1), (2, 2), (3, 2), (16, 5), (37, 37)])
def test_plain_selection_on_given_scores_equals_the_jax_rounds(proxy, c, k):
    """`proxy_select_ref(..., scores=)` on scores with planted ties and equal
    values gives the JAX kernel's rounds' depths, in order."""
    _, _, tpack = proxy
    rng = np.random.default_rng(c)
    rays = torch.from_numpy(rays_np(40, seed=c))
    scores = _tied_scores(rng, 40, c)
    scores[:8] = rng.normal(size=(8, c)).astype(np.float32)   # and some without ties
    z = k6.candidate_depths(rays, c).numpy()
    got = k6.proxy_select_ref(tpack, rays, c, k, scores=torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, jax_rounds_np(scores, z, k))


@pytest.mark.parametrize("tied", [False, True])
def test_rank_rule_equals_the_stable_descending_sort(tied):
    """The kernel's rank rule (`rank_select_ref`) keeps the same candidates
    in the same order as the plain version's stable descending sort, for
    every K."""
    rng = np.random.default_rng(11)
    for c in (1, 2, 3, 8, 33, 64):
        s = _tied_scores(rng, 50, c) if tied else rng.normal(size=(50, c)).astype(np.float32)
        s = torch.from_numpy(s)
        for k in sorted({1, (c + 1) // 2, c}):
            assert torch.equal(k6.rank_select_ref(s, k), k6.select_order(s, k)), (c, k)


def test_candidate_counts_above_the_shared_memory_row_take_a_scratch():
    """K3 and K6 take any C from 4 (1 for K6) to MAX_C: up to MAX_CANDIDATES
    no scratch (`scratch_for` None, nothing allocated), above it one row of
    C | 1 floats per CTA; the wrappers check C against MAX_C, not the
    shared-memory cap, and run the plain version on the CPU above it."""
    assert k3.MAX_CANDIDATES == 53103 and k6.MAX_CANDIDATES == k3.MAX_CANDIDATES
    assert k3.MAX_C == 1 << 30
    for c in (4, 256, k3.MAX_CANDIDATES):
        assert k3.scratch_for(64, c, 10, "cpu") is None
    assert k3.scratch_for(64, k3.MAX_CANDIDATES + 1, 0, "cpu") is None   # no rays: no launch
    assert k3.scratch_args(None) == (None, 0)
    k3.check_range("proxy_opacity", "candidates", k3.MAX_CANDIDATES + 1, 4, k3.MAX_C)
    with pytest.raises(ValueError, match="got 3"):
        k3.check_range("proxy_opacity", "candidates", 3, 4, k3.MAX_C)


def test_cut_swaps_measures_the_swaps_against_their_bars():
    """`cut_swaps` counts the rays whose kept sets differ and gives the
    largest gap between swapped candidates' plain scores over their bars'
    sum; a reordering within the kept set is no swap."""
    ref = torch.tensor([[3.0, 2.0, 1.0, 0.5], [1.0, 2.0, 3.0, 4.0]])
    bar = torch.full_like(ref, 0.25)
    assert k6.cut_swaps(ref, bar, ref, 2) == (0, 0.0)
    assert k6.cut_swaps(ref, bar, torch.tensor([[2.0, 3.0, 1.0, 0.5], [1.0, 2.0, 3.0, 4.0]]),
                        2) == (0, 0.0)
    # ray 0 keeps candidate 2 (plain 1.0) in place of 1 (plain 2.0): a gap of 1.0 over 0.5
    got = torch.tensor([[3.0, 0.9, 1.0, 0.5], [1.0, 2.0, 3.0, 4.0]])
    assert k6.cut_swaps(ref, bar, got, 2) == (1, 2.0)


def test_proxy_select_at_one_candidate_gives_near_without_a_launch(proxy):
    """On the CPU `proxy_select` runs its plain version and counts no
    launch; at C 1 every depth is its ray's near, as JAX's
    linspace(0, 1, 1) gives, and none is NaN; `proxy_select_scores` gives
    the plain scores and the same depths."""
    _, _, tpack = proxy
    rays = torch.from_numpy(rays_np(21, seed=4))
    rays[:, 6] = torch.linspace(0.5, 2.5, 21)
    before = dict(k6.LAUNCHES)
    z = k6.proxy_select(tpack, rays, 1, 1)
    assert torch.equal(z, rays[:, 6:7])
    scores, z2 = k6.proxy_select_scores(tpack, rays, 3, 2)
    assert torch.equal(scores, k6.candidate_scores_ref(tpack, rays, 3))
    assert torch.equal(z2, k6.proxy_select(tpack, rays, 3, 2))
    assert k6.LAUNCHES == before
    with pytest.raises(ValueError, match="n_keep 3 of 2"):
        k6.proxy_select(tpack, rays, 2, 3)
