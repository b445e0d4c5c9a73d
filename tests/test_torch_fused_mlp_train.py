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
    assert set(whole) == set(packed)
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
