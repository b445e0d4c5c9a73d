"""The port's fused training field (K2's plain version, which the wrappers
run on the CPU, and the autograd Function around it) against the JAX
package's `fused_field_train`, whose Pallas forward and backward kernels
run in interpret mode here. Full width (K2 is fixed to 8x256), one TPU tile
of 1024 points, the same weights on both sides through `convert.py`.

Tolerances and why:
- forward: atol 2e-3 / rtol 1e-2, the K1 tests' bar: bf16 operands and f32
  sums on both sides; the TPU kernel forms cos as sin(x + pi/2) and sums
  the embedding's raw and sin/cos rows in two products.
- loss: rtol 1e-4; gradients: relative L2 below 1e-2 per leaf, plus an
  elementwise bound of 2e-2 of the leaf's largest value. The port follows
  the TPU semantics and rounds every cotangent to bf16 before each weight
  gradient product; JAX on the CPU multiplies the float32 cotangent there
  (`_op_dtype`), so the two differ by that rounding, compounded down the
  dgrad chain.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_siren_tpu.config import NeRFConfig
from nerf_siren_tpu.models.nerf import init_nerf
from nerf_siren_tpu.ops.pallas.fused_mlp_train import TILE_T, fused_field_train
from nerf_siren_tpu_torch.convert import nerf_from_jax
from nerf_siren_tpu_torch.models.nerf import NeRF
from nerf_siren_tpu_torch.ops.kernels import fused_mlp_train as k2
from tests.test_torch_semantic import one_torch_thread  # noqa: F401 (autouse)

FWD_TOL = dict(atol=2e-3, rtol=1e-2)


def _bf16_exact(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(n, seed, n_dirs=None):
    """Points and unit directions, rounded to bf16-representable values: the
    TPU kernel and the port round the raw coordinates to bf16 where they
    enter a product, but JAX's interpret run on the CPU multiplies them in
    float32 (`_op_dtype`), and that alone moves layer 0's gradient by ~3%
    (relative L2) through the dgrad chain."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n if n_dirs is None else n_dirs, 3)).astype(np.float32)
    return _bf16_exact(xyz), _bf16_exact(d / np.linalg.norm(d, axis=-1, keepdims=True))


def _t(a):  # (N, 3) -> the JAX kernel's (8, N) layout
    return jnp.pad(jnp.asarray(a).T, ((0, 8 - a.shape[1]), (0, 0)))


def _model(params):
    model = NeRF(NeRFConfig())
    model.load_state_dict(nerf_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.fixture(scope="module")
def field():
    params = init_nerf(jax.random.PRNGKey(1), NeRFConfig())
    return params, _model(params)


def test_plain_forward_matches_jax_kernel(field):
    params, model = field
    xyz, d = _inputs(TILE_T, 3)
    ref = np.asarray(fused_field_train(params, _t(xyz), _t(d)))[:4].T
    got = k2.fused_train_fwd(k2.pack_train_params(model.state_dict()),
                             torch.from_numpy(xyz), torch.from_numpy(d)).numpy()
    assert got.shape == (TILE_T, 4)
    np.testing.assert_allclose(got, ref, **FWD_TOL)


def test_plain_forward_ragged_n_one_direction_per_ray(field):
    """N = 1001 (no multiple of any tile), 8 points per direction: equal to
    the JAX kernel on the zero-padded tile with per-point directions."""
    params, model = field
    n, spd = 1001, 8
    xyz, d = _inputs(n, 4, n_dirs=-(-n // spd))
    d_pt = np.repeat(d, spd, 0)[:n]
    pad = TILE_T - n
    ref = np.asarray(fused_field_train(params, _t(np.pad(xyz, ((0, pad), (0, 0)))),
                                       _t(np.pad(d_pt, ((0, pad), (0, 0))))))[:4, :n].T
    packed = k2.pack_train_params(model.state_dict())
    got = k2.fused_train_fwd(packed, torch.from_numpy(xyz), torch.from_numpy(d), spd)
    np.testing.assert_allclose(got.numpy(), ref, **FWD_TOL)
    per_point = k2.fused_train_fwd(packed, torch.from_numpy(xyz), torch.from_numpy(d_pt))
    torch.testing.assert_close(got, per_point, rtol=0, atol=0)


def test_plain_grads_match_jax_grad(field):
    params, model = field
    xyz, d = _inputs(TILE_T, 5)
    # positive weights: a loss without cancellation, so rtol means something
    w4 = np.random.default_rng(7).uniform(0.5, 1.5, (TILE_T, 4)).astype(np.float32)

    def loss(p):
        out = fused_field_train(p, _t(xyz), _t(d))[:4].T
        return jnp.sum(out * w4) / TILE_T

    ref_loss, ref_g = jax.value_and_grad(loss)(params)
    packed = k2.pack_train_params(model.state_dict())
    x_t, d_t = torch.from_numpy(xyz), torch.from_numpy(d)
    got_loss = float((k2.fused_train_fwd(packed, x_t, d_t) * torch.from_numpy(w4)).sum() / TILE_T)
    np.testing.assert_allclose(got_loss, float(ref_loss), rtol=1e-4)

    got = k2.grads_to_state_dict(
        k2.fused_train_bwd(packed, x_t, d_t, torch.from_numpy(w4) / TILE_T))
    want = nerf_from_jax(jax.tree_util.tree_map(np.asarray, ref_g))
    assert set(got) == set(want)
    for k, b in want.items():
        a, b = got[k].double().numpy(), b.double().numpy()
        assert a.shape == b.shape, k
        rel_l2 = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert rel_l2 < 1e-2, f"{k}: rel L2 {rel_l2:.4f}"
        scale = max(np.abs(b).max(), 1e-9)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-2, err_msg=k)


def test_autograd_function_matches_autograd_through_plain_forward(field):
    """`fused_field_train` (the plain backward on CPU tensors) against
    torch autograd through the plain forward on a differentiable pack, which
    keeps float32 cotangents: relative L2 below 1e-2 per parameter."""
    _, model = field
    xyz, d = _inputs(512, 6, n_dirs=64)
    x_t, d_t = torch.from_numpy(xyz), torch.from_numpy(d)
    w4 = torch.from_numpy(np.random.default_rng(8).normal(size=(512, 4)).astype(np.float32))

    before = dict(k2.LAUNCHES)
    model.zero_grad()
    out = k2.fused_field_train(model, x_t, d_t, samples_per_dir=8)
    (out * w4).sum().backward()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert k2.LAUNCHES == before      # CPU tensors never launch a kernel

    model.zero_grad()
    ref_out = k2.fused_train_fwd_ref(k2._pack(dict(model.named_parameters())), x_t, d_t, 8)
    (ref_out * w4).sum().backward()
    torch.testing.assert_close(out.detach(), ref_out.detach(), rtol=0, atol=0)
    for k, p in model.named_parameters():
        rel = float((got[k] - p.grad).norm() / p.grad.norm().clamp_min(1e-12))
        assert rel < 1e-2, f"{k}: rel L2 {rel:.4f}"
    model.zero_grad()


def test_backward_over_two_halves_sums_to_the_whole(field):
    _, model = field
    xyz, d = _inputs(600, 9)
    dy = torch.from_numpy(np.random.default_rng(2).normal(size=(600, 4)).astype(np.float32))
    x_t, d_t = torch.from_numpy(xyz), torch.from_numpy(d)
    packed = k2.pack_train_params(model.state_dict())
    whole = k2.fused_train_bwd(packed, x_t, d_t, dy)
    a = k2.fused_train_bwd(packed, x_t[:300], d_t[:300], dy[:300])
    b = k2.fused_train_bwd(packed, x_t[300:], d_t[300:], dy[300:])
    assert set(whole) == set(packed) - {"k2_stream"}   # a gradient per weight, none for the stream
    for k, v in whole.items():
        assert v.shape == packed[k].shape and v.dtype == torch.float32, k
        torch.testing.assert_close(a[k] + b[k], v, rtol=1e-4, atol=1e-6, msg=k)


def test_fused_field_rejects_other_topologies():
    with pytest.raises(ValueError, match="reference 8x256"):
        k2.fused_field_train(NeRF(NeRFConfig(depth=4, width=64, skips=(2,))),
                             torch.zeros((4, 3)), torch.zeros((4, 3)))


def test_field_fn_needs_directions(field):
    _, model = field
    fn = k2.make_fused_train_field_fn(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="full evaluations"):
        fn(model, torch.zeros((2, 4, 3)), None)


# ---- the backward kernels' stream, stash layout and plan (no JAX) -----------

def test_k2_stream_unpacks_to_every_weight(field):
    """The stream rebuilds each weight it holds: the recompute's slices W,
    the dgrad chain's W^T (every hidden layer, W_feat, W_dfeat)."""
    _, model = field
    packed = k2.pack_train_params(model.state_dict())
    got = k2.unpack_k2_stream(packed["k2_stream"])
    fwd = [f"w{i}" for i in range(1, k2.DEPTH)] + ["w0e", f"w{k2.SKIP}e", "w_feat", "w_dfeat"]
    bwd = [f"w{i}" for i in range(1, k2.DEPTH)] + ["w_feat", "w_dfeat"]
    assert set(got) == {(k, False) for k in fwd + ["w_ddir"]} | {(k, True) for k in bwd}
    for k in fwd:
        assert torch.equal(got[(k, False)], packed[k]), k
    for k in bwd:
        assert torch.equal(got[(k, True)], packed[k].t()), k
    assert torch.equal(got[("w_ddir", False)][:, :k2.EMB_D], packed["w_ddir"])
    assert not got[("w_ddir", False)][:, k2.EMB_D:].any()


def test_k2_stream_forward_prefix_holds_the_forward_weights(field):
    """The forward reads the stream's first K2_FWD_SLICES slices: exactly
    the forward's weights (w0e, w1..w7, w4e, w_feat, w_dfeat and w_ddir
    padded to 64 inputs), untransposed, and no slice of the dgrad chain;
    the dgrad chain starts right after it."""
    _, model = field
    packed = k2.pack_train_params(model.state_dict())
    stream = packed["k2_stream"]
    got = k2.unpack_k2_forward(stream[:k2.K2_FWD_STREAM_NUMEL])
    fwd = [f"w{i}" for i in range(1, k2.DEPTH)] + ["w0e", f"w{k2.SKIP}e", "w_feat", "w_dfeat"]
    assert set(got) == {(k, False) for k in fwd + ["w_ddir"]}
    for k in fwd:
        assert torch.equal(got[(k, False)], packed[k]), k
    assert torch.equal(got[("w_ddir", False)][:, :k2.EMB_D], packed["w_ddir"])
    assert not got[("w_ddir", False)][:, k2.EMB_D:].any()
    assert k2.K2_FWD_SLICES == 39 and k2.K2_FWD_STREAM_NUMEL == 34 * 256 * 64 + 5 * 128 * 64
    assert all(t for _, t, _ in k2.k2_schedule()[k2.K2_FWD_SLICES:])
    with pytest.raises(ValueError, match="k2_stream"):
        k2.unpack_k2_forward(stream)


def test_k2_stream_order_and_swizzle(field):
    """Slice j of the stream is its schedule entry's (rows, 64) block with
    8-element chunk c of row r at chunk c ^ (r % 8), in the order the tile
    kernel consumes: 34 recompute slices of 256 rows, 5 of 128, 34 dgrad
    slices of 256 rows (1,155,072 elements)."""
    _, model = field
    packed = k2.pack_train_params(model.state_dict())
    stream = packed["k2_stream"].view(torch.int16)
    sched = k2.k2_schedule()
    rows = [k2._slice_rows(k, t) for k, t, _ in sched]
    assert rows == [256] * 34 + [128] * 5 + [256] * 34
    assert stream.numel() == k2.K2_STREAM_NUMEL == (34 + 34) * 256 * 64 + 5 * 128 * 64
    assert sched[:6] == [("w0e", False, 0), ("w1", False, 0), ("w1", False, 64),
                         ("w1", False, 128), ("w1", False, 192), ("w2", False, 0)]
    assert sched[17] == (f"w{k2.SKIP}e", False, 0) and sched[39] == ("w_dfeat", True, 0)
    assert sched[-1] == ("w1", True, 192)
    off = 0
    for j, ((k, t, c), n) in enumerate(zip(sched, rows)):
        if j in (0, 17, 36, 38, 39, 44, 72):
            w = packed[k].t() if t else packed[k]
            w = torch.nn.functional.pad(w, (0, 64))[:, c: c + 64].contiguous().view(torch.int16)
            s = stream[off: off + n * 64].view(n, 64)
            for r in (0, 1, 7, 8, n - 1):
                for chunk in range(8):
                    stored = (chunk ^ (r % 8)) * 8
                    assert torch.equal(s[r, stored: stored + 8],
                                       w[r, chunk * 8: chunk * 8 + 8]), (j, r)
        off += n * 64


@pytest.mark.parametrize("n,cols", [(1, 16), (127, 32), (129, 64), (300, 256)])
def test_block_stash_round_trips_in_the_kernels_layout(n, cols):
    """`block_stash` puts (point p, feature f) where the backward's kernels
    do (csrc/fused_mlp_train.cu's head): block p // 64 of cols rows of 64,
    chunk ((p % 64) // 8) ^ (f % 8) of row f; rows past n (to whole tiles of
    128) are zero; `unblock_stash` inverts it."""
    x = torch.arange(1, n * cols + 1, dtype=torch.float32).view(n, cols)
    flat = k2.block_stash(x)
    n_pad = -(-n // 128) * 128
    assert flat.numel() == n_pad * cols
    for p in sorted({0, 7, 8, 63, n - 1} & set(range(n))):
        for f in sorted({0, 1, 7, 9, cols - 1}):
            r = p % 64
            at = (p // 64) * cols * 64 + f * 64 + ((r // 8) ^ (f % 8)) * 8 + r % 8
            assert flat[at] == x[p, f], (p, f)
    assert int((flat != 0).sum()) == n * cols
    assert torch.equal(k2.unblock_stash(flat, n, cols), x)


@pytest.mark.parametrize("n", [1, 127, 129, 4099, 65536, 196608])
def test_wgrad_plan_covers_every_gradient_once(n):
    """The weight-gradient GEMM's jobs produce every weight gradient of the
    pack once, each in CTA tiles of 128 rows that cover its rows; its slabs
    cover every 64-point block of the stash once, none empty, at most 32."""
    shapes = k2._WEIGHT_SHAPES
    jobs = k2.wgrad_jobs()
    assert sorted(j[4] for j in jobs) == sorted(shapes)
    for rows, fa, cols, fb, key, transposed in jobs:
        assert fa == k2.STASH_FEATURES[rows] and fb == k2.STASH_FEATURES[cols]
        assert fa % k2.G_M == 0
        if transposed:   # the (HEAD, in) head block whose rows hold w_sigma / w_rgb
            rows_of_key = shapes[key][0] if key == "w_sigma" else shapes[key][1]
            assert cols == "dhead" and fa == rows_of_key
        else:
            assert (fa, fb) == shapes[key], key
    assert sum(j[1] // k2.G_M for j in jobs) == 25
    blocks, slab, splits = k2.wgrad_split_plan(n)
    assert blocks == -(-n // 128) * 2 and 1 <= splits <= 32
    starts = [s * slab for s in range(splits)]
    assert all(s < blocks for s in starts) and starts[-1] + slab >= blocks
    assert sum(min(s + slab, blocks) - s for s in starts) == blocks


def test_stash_bytes_per_point():
    """Counted from the layout: 9,952 bytes a point written by the tile
    kernel, 15,776 read by the weight-gradient GEMM (its 128-row tiles read
    the narrow operand once per tile)."""
    assert k2.stash_bytes_per_point() == (9952, 15776)
