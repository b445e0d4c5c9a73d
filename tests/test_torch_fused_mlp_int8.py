"""The port's int8 NeRF field (K4's plain version, which the wrappers run on
the CPU) against the JAX package's int8 Pallas kernel, run in interpret
mode with `fused_mlp.TILE_N` shrunk to 128 as tests/test_fused_int8.py
does, and the int8 pack dispatch of both renderers against JAX's.

Tolerances are tests/test_fused_int8.py's: rgb atol 2e-2, sigma atol 5e-2
and rtol 2e-2. The integer sums are exact on both sides, so the outputs
differ only where a float32 value rounds across a .5 boundary of the int8
grid (the summation order of a scale product or of the bf16 heads moves
it by an ulp) and by the heads' bf16 summation order. The renders: the
fused renderer's outputs atol 5e-3 / rtol 2e-2 (the bf16 slice bar of
tests/test_torch_fused_mlp.py); the fast renderer's per output median
|d| < 2e-3 and 99th percentile < 0.05 of the output's scale max(1,
max |ref|) (tests/test_proxy_march.py's bars).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig, RenderConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.ops.pallas import fused_mlp as jfm
from nerf_siren_tpu.ops.pallas import fused_mlp_int8 as jk4
from nerf_siren_tpu.ops.pallas import proxy_march as jpm
from nerf_siren_tpu.render import fast as jfast
from nerf_siren_tpu.render.fused import render_rays_fused as j_render_rays_fused
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp_int8 as k4
from nerf_siren_tpu_torch.ops.kernels import proxy_march as k3
from nerf_siren_tpu_torch.render import fast
from nerf_siren_tpu_torch.render.fused import field_kernels, render_rays_fused
from nerf_siren_tpu_torch.ops.kernels.fused_mlp import KERNEL_WIDTHS
from tests.test_torch_fused_mlp import STREAM_CASES, width_id
from tests.test_torch_proxy_march import port_proxy, rays_np
from tests.test_torch_rendering import with_density

SMALL = NeRFConfig(depth=5, width=128)


@pytest.fixture(scope="module", autouse=True)
def small_tile():
    old = jfm.TILE_N
    jfm.TILE_N = 128  # keep interpreter-mode runs of the JAX kernels fast
    yield
    jfm.TILE_N = old


def _model(params):
    model = NeRF(SMALL)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def field():
    params = with_density(init_nerf(jax.random.PRNGKey(0), SMALL))
    return params, jk4.pack_nerf_params_int8(params, SMALL), k4.pack_nerf_params_int8(_model(params))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return xyz, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_int8_pack_quantises_as_jax(field):
    """The int8 weights and row scales equal JAX's for the hidden layers, and
    the coordinate columns of layer 0 (JAX keeps them in its own row order
    for the sin/cos columns, so those are compared through the outputs)."""
    _, jpack, tpack = field
    for i in (1, 2, 3):
        np.testing.assert_array_equal(tpack[f"q{i}"].numpy(), np.asarray(jpack[f"q{i}"]))
        np.testing.assert_allclose(tpack[f"f{i}"].numpy(), np.asarray(jpack[f"f{i}"])[:, 0],
                                   rtol=1e-6)
    np.testing.assert_array_equal(tpack["q4"].numpy(), np.asarray(jpack["q4h"]))
    np.testing.assert_array_equal(tpack["q0x"].numpy(), np.asarray(jpack["q0x"])[:, :3])


@pytest.mark.parametrize("n", [200, 130])
def test_full_and_sigma_match_jax(field, n):
    params, jpack, tpack = field
    xyz, d = _points(n, n)
    xyz_t = jfm._pad_lanes(jnp.asarray(xyz).T, jfm.TILE_N)
    dir_t = jfm._pad_lanes(jnp.asarray(d).T, jfm.TILE_N)
    want = np.asarray(jk4.fused_full_t_int8(jpack, xyz_t, dir_t, depth=SMALL.depth,
                                            skips=SMALL.skips)[:4, :n].T)
    want_sigma = np.asarray(jk4.fused_sigma_t_int8(jpack, xyz_t, depth=SMALL.depth,
                                                   skips=SMALL.skips)[jfm.SIGMA_ROW, :n])
    got = k4.fused_nerf_full_int8(tpack, torch.from_numpy(xyz), torch.from_numpy(d)).numpy()
    got_sigma = k4.fused_nerf_sigma_int8(tpack, torch.from_numpy(xyz)).numpy()[:, 0]
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[:, 3], want[:, 3], atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got_sigma, want_sigma, atol=5e-2, rtol=2e-2)
    # the plain version's sigma pass is its full pass's sigma, exactly
    np.testing.assert_array_equal(got_sigma, got[:, 3])


@pytest.mark.parametrize("n", [130])
def test_width_384_matches_jax(n):
    """At width 384 (one of the kernel's split widths), depth 5 with the skip
    at 4 (the shortest depth of JAX's one topology): both plain passes
    against JAX's int8 kernel in interpret mode, within the bars above."""
    cfg = NeRFConfig(depth=5, width=384)
    params = with_density(init_nerf(jax.random.PRNGKey(1), cfg))
    model = NeRF(cfg)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    jpack, tpack = jk4.pack_nerf_params_int8(params, cfg), k4.pack_nerf_params_int8(model)
    assert "k4_stream" in tpack
    xyz, d = _points(n, 7)
    xyz_t = jfm._pad_lanes(jnp.asarray(xyz).T, jfm.TILE_N)
    dir_t = jfm._pad_lanes(jnp.asarray(d).T, jfm.TILE_N)
    want = np.asarray(jk4.fused_full_t_int8(jpack, xyz_t, dir_t, depth=cfg.depth,
                                            skips=cfg.skips)[:4, :n].T)
    want_sigma = np.asarray(jk4.fused_sigma_t_int8(jpack, xyz_t, depth=cfg.depth,
                                                   skips=cfg.skips)[jfm.SIGMA_ROW, :n])
    got = k4.fused_nerf_full_int8(tpack, torch.from_numpy(xyz), torch.from_numpy(d)).numpy()
    got_sigma = k4.fused_nerf_sigma_int8(tpack, torch.from_numpy(xyz)).numpy()[:, 0]
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[:, 3], want[:, 3], atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got_sigma, want_sigma, atol=5e-2, rtol=2e-2)


WIDE_CASES = [(640, 8), (1024, 8), (128, 2), (128, 20)]


@pytest.mark.parametrize("width,depth", WIDE_CASES, ids=[f"w{w}-d{d}" for w, d in WIDE_CASES])
def test_wide_shapes_match_jax(width, depth):
    """The plain versions at the wide kernel's shapes (csrc/fused_mlp_wide.cu):
    widths 640 and 1024 at depth 8, depths 2 and 20 at width 128, the skip
    at 4 (JAX's one topology), 130 points: both passes against JAX's int8
    kernel in interpret mode (`fused_full_t_int8` / `fused_sigma_t_int8`),
    within the module's bars."""
    cfg = NeRFConfig(depth=depth, width=width)
    params = with_density(init_nerf(jax.random.PRNGKey(3), cfg))
    model = NeRF(cfg)
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    jpack, tpack = jk4.pack_nerf_params_int8(params, cfg), k4.pack_nerf_params_int8(model)
    assert "k4_stream" in tpack
    n = 130
    xyz, d = _points(n, 13)
    xyz_t = jfm._pad_lanes(jnp.asarray(xyz).T, jfm.TILE_N)
    dir_t = jfm._pad_lanes(jnp.asarray(d).T, jfm.TILE_N)
    want = np.asarray(jk4.fused_full_t_int8(jpack, xyz_t, dir_t, depth=cfg.depth,
                                            skips=cfg.skips)[:4, :n].T)
    want_sigma = np.asarray(jk4.fused_sigma_t_int8(jpack, xyz_t, depth=cfg.depth,
                                                   skips=cfg.skips)[jfm.SIGMA_ROW, :n])
    got = k4.fused_nerf_full_int8(tpack, torch.from_numpy(xyz), torch.from_numpy(d)).numpy()
    got_sigma = k4.fused_nerf_sigma_int8(tpack, torch.from_numpy(xyz)).numpy()[:, 0]
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=2e-2, rtol=0)
    np.testing.assert_allclose(got[:, 3], want[:, 3], atol=5e-2, rtol=2e-2)
    np.testing.assert_allclose(got_sigma, want_sigma, atol=5e-2, rtol=2e-2)


def test_trunk_inputs_are_int8_of_the_plain_math(field):
    """`int8_trunk_inputs` on the CPU: slot 0 holds the quantised
    coordinates and sin/cos, every slot is within +-127, and it is what
    the plain field consumed (its sigma follows from the slots)."""
    _, _, tpack = field
    xyz, _ = _points(64, 3)
    q = k4.int8_trunk_inputs(tpack, torch.from_numpy(xyz))
    assert q.dtype == torch.int8 and q.shape == (SMALL.depth, 64, SMALL.width)
    assert int(q.abs().max()) == 127
    absmax = np.abs(xyz).max(-1, keepdims=True)
    np.testing.assert_array_equal(q[0, :, :3].numpy(),
                                  np.clip(np.round(xyz / (absmax / 127.0)), -127, 127))


def test_fused_renderer_dispatches_the_int8_pack(field):
    """render_rays_fused with int8 packs (field_kernels picks K4 by 'q0x')
    against JAX's render_rays_fused with its int8 packs."""
    params, jpack, tpack = field
    assert field_kernels(tpack)[1] is k4.fused_nerf_full_int8
    r = 16
    rng = np.random.default_rng(9)
    o = rng.uniform(-0.3, 0.3, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((r, 1), 0.5, np.float32),
                           np.full((r, 1), 2.0, np.float32)], -1)
    cfg = RenderConfig(n_samples=16, n_importance=8, perturb=0.0, noise_std=0.0,
                       white_back=True, test_time=True)
    want = j_render_rays_fused({"coarse": jpack, "fine": jpack}, jnp.asarray(rays), cfg,
                               nerf_cfg=SMALL)
    got = render_rays_fused({"coarse": tpack, "fine": tpack}, torch.from_numpy(rays), cfg)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=5e-3, rtol=2e-2,
                                   err_msg=k)


def test_fast_renderer_dispatches_the_int8_pack(field):
    """render_rays_fast's kernel route (K3 then the field at the survivors)
    with an int8 pack, against JAX's, on R = TILE_R rays."""
    params, jpack, tpack = field
    tree = jfast.init_proxy(jax.random.PRNGKey(3), hidden=96)
    rays = rays_np(jpm.TILE_R, seed=2)
    kw = dict(n_candidates=16, n_keep=8, white_back=True, select="pdf")
    want = jfast.render_rays_fast({"fine": params}, tree, jnp.asarray(rays), nerf_cfg=SMALL,
                                  packed_params={"fine": jpack},
                                  packed_proxy=jpm.pack_proxy_params(tree), **kw)
    proxy = port_proxy(tree)
    with torch.no_grad():
        got = fast.render_rays_fast(None, proxy, torch.from_numpy(rays),
                                    packed_params={"fine": tpack},
                                    packed_proxy=k3.pack_proxy_params(proxy), **kw)
    for k, v in got.items():
        ref = np.asarray(want[k])
        err = np.abs(v.numpy() - ref) / max(1.0, float(np.abs(ref).max()))
        assert np.median(err) < 2e-3 and np.percentile(err, 99) < 0.05, k


# ---- the kernel's weight stream (k4_stream) ----------------------------------

def _int8_pack(depth, skips, width=256):
    from nerf_siren_tpu_torch.config import NeRFConfig as TorchNeRFConfig

    model = NeRF(TorchNeRFConfig(depth=depth, width=width, skips=skips),
                 generator=torch.Generator().manual_seed(depth))
    return k4.pack_nerf_params_int8(model)


@pytest.mark.parametrize("width,depth,skips", [
    pytest.param(w, d, s, id=width_id(w, f"{d}-skips{i}"))
    for w in KERNEL_WIDTHS for i, (d, s) in enumerate(STREAM_CASES)])
def test_k4_stream_unpacks_to_every_weight(width, depth, skips):
    """The plain inverse rebuilds every streamed weight of the pack exactly:
    each q* int8 weight (the sin/cos columns' padding to 128 inputs zero),
    and K1's bf16 W_comb and W_dir (W_dir's padding to 64 inputs zero)."""
    packed = _int8_pack(depth, skips, width)
    emb_layers = [0, *skips]
    got = k4.unpack_k4_stream(packed["k4_stream"], depth, emb_layers, width)
    expect = ({f"q{i}" for i in range(1, depth)} | {f"q{i}s" for i in emb_layers}
              | {"w_comb", "w_dir"})
    assert set(got) == expect
    for k in expect:
        want = packed[k]
        assert got[k].dtype == want.dtype, k
        assert torch.equal(got[k][:, :want.shape[1]], want), k
        assert not got[k][:, want.shape[1]:].float().any(), k
    assert got["q0s"].shape == (width, 128) and got["w_dir"].shape == (width // 2, 64)


# n_trunk = 1 + (depth - 1) W / 128 + the skips: the reference field 16 int8
# trunk slices at width 256, depth 3 with the skip at 1 6 (9 / 4 at width 128,
# 23 / 8 at 384, 30 / 10 at 512); W / 64 + 1 bf16 direction slices
@pytest.mark.parametrize("width,depth,skips,n_trunk", [
    pytest.param(w, d, s, n, id=width_id(w, f"{d}-skips{i}-{n}"))
    for w in KERNEL_WIDTHS for i, (d, s) in enumerate(STREAM_CASES)
    for n in [1 + (d - 1) * w // 128 + len(s)]])
def test_k4_stream_order_and_swizzle(width, depth, skips, n_trunk):
    """The slice count and order documented in csrc/fused_mlp_int8.cu, and
    each byte where the 128-byte swizzle puts it: byte (r, c) of a slice's
    rows of 128 bytes at r * 128 + ((c // 16) ^ (r % 8)) * 16 + c % 16."""
    packed = _int8_pack(depth, skips, width)
    sched = k4.k4_schedule(depth, [0, *skips], width)
    trunk = [("q0s", 0)]
    for i in range(1, depth):
        trunk += ([(f"q{i}", c) for c in range(0, width, 128)]
                  + ([(f"q{i}s", 0)] if i in skips else []))
    assert len(trunk) == n_trunk
    n_dir = width // 64 + 1
    assert sched == trunk + [("w_comb", c) for c in range(0, width, 64)] + [("w_dir", 0)]
    stream = packed["k4_stream"]
    assert stream.dtype == torch.int8
    assert stream.numel() == n_trunk * width * 128 + n_dir * (width // 2) * 128
    stream = stream.numpy()
    r, c = np.meshgrid(np.arange(width), np.arange(128), indexing="ij")
    off = 0
    for k, c0 in sched:
        w = packed[k]
        if w.dtype == torch.bfloat16:           # 64 inputs of 2 bytes per row
            w = torch.nn.functional.pad(w, (0, max(0, c0 + 64 - w.shape[1])))[:, c0: c0 + 64]
            rows_bytes = w.contiguous().view(torch.int8).numpy()
        else:                                   # 128 int8 inputs per row
            w = torch.nn.functional.pad(w, (0, max(0, c0 + 128 - w.shape[1])))[:, c0: c0 + 128]
            rows_bytes = w.numpy()
        rows = rows_bytes.shape[0]
        rr, cc = r[:rows], c[:rows]
        np.testing.assert_array_equal(
            stream[off + rr * 128 + ((cc // 16) ^ (rr % 8)) * 16 + cc % 16], rows_bytes,
            err_msg=f"{k}[:, {c0}:]")
        off += rows * 128
    assert off == stream.size


def test_k4_stream_only_at_the_kernel_width():
    """The int8 pack carries k4_stream at every width the kernels take (any
    multiple of 128: 640 runs on the wide kernel, and its stream
    round-trips through `unpack_k4_stream`) and never k1_stream; at 192
    neither, and its inverse refuses a stream of the wrong size."""
    for width in (128, 256, 384, 512, 640, 192):
        packed = _int8_pack(3, (1,), width)
        assert ("k4_stream" in packed) == (width % 128 == 0), width
        assert "k1_stream" not in packed
    packed = _int8_pack(3, (1,), 640)
    got = k4.unpack_k4_stream(packed["k4_stream"], 3, [0, 1], 640)
    for k in ("q1", "q2", "w_comb"):
        assert torch.equal(got[k], packed[k]), k
    assert torch.equal(got["q1s"][:, :k4.EMB_Q], packed["q1s"])
    packed = _int8_pack(3, (1,))
    with pytest.raises(ValueError, match="k4_stream"):
        k4.unpack_k4_stream(packed["k4_stream"][:-1], 3, [0, 1], 256)
